from .quantize import dequantize, quantize  # noqa: F401
