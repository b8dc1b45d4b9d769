from .optimizer import (AdamWConfig, OptState, adamw_init, adamw_update,
                        clip_by_global_norm, compress_int8, cosine_schedule,
                        decompress_int8)
from .step import (TrainState, init_train_state, make_decode_step,
                   make_eval_step, make_prefill_step, make_train_step)
