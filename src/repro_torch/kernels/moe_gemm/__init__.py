from .kernel import moe_gemm
from .ops import grouped_gemm
from .ref import moe_gemm_ref
