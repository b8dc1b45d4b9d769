from .kernel import bsr_spgemm, run_starts_from_flags
from .ops import local_spgemm_device, schedule_flags
from .ref import bsr_spgemm_ref
