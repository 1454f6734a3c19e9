from .optimizer_swapper import NVMeLeafStore

__all__ = ["NVMeLeafStore"]
