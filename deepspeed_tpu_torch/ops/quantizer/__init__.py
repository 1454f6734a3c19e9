from .quantize import (  # noqa: F401
    annealed_bits,
    dequantize,
    fake_quant,
    fake_quant_dynamic,
    quantize,
)
