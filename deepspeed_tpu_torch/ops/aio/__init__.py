from .handle import AsyncIOHandle

__all__ = ["AsyncIOHandle"]
