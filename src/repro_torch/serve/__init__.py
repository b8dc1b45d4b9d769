from .engine import GenerationResult, ServeEngine
from .spgemm_service import (SERVICE_STATS, ServedResult, ServicePolicy,
                             SpGEMMRequest, SpGEMMService,
                             TenantOverloadError)
