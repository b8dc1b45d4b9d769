from .amg import GalerkinResult, galerkin_product
from .bc import BCResult, bc_batch, device_spgemm_fn
from .mcl import MCLResult, mcl
from .sketch import SketchResult, count_sketch, sketch_apply, sketch_stream
