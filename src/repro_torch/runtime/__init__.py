from .fault_tolerance import CircuitBreaker, RetryPolicy, with_retries
from .faults import (STAGES, FaultInjector, InjectedFault,
                     SimulatedCorruption, SimulatedDeviceError, SimulatedOOM)
