from specdec_tpu_torch.quant.core import (
    Int4Weight,
    StackedSlice,
    dequantize,
    qmatmul,
    quantize_int4,
    quantize_params,
)
