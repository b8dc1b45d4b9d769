from .fault_tolerance import CircuitBreaker, RetryPolicy, with_retries
from .faults import (STAGES, FaultInjector, InjectedFault,
                     SimulatedCorruption, SimulatedDeviceError, SimulatedOOM)
from .resumable import (LoopCheckpointer, pack_csc, pack_csc_list,
                        unpack_csc, unpack_csc_list)
