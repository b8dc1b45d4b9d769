from .kernel import flash_attention
from .ops import multihead_attention
from .ref import attention_ref
