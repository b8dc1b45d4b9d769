from .fault_tolerance import (CircuitBreaker, RetryPolicy, StepTimer,
                              StragglerStats, TrainLoopRunner, with_retries)
from .faults import (STAGES, FaultInjector, InjectedFault,
                     SimulatedCorruption, SimulatedDeviceError, SimulatedOOM)
from .resumable import (LoopCheckpointer, pack_csc, pack_csc_list,
                        unpack_csc, unpack_csc_list)
