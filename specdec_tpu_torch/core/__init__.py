from specdec_tpu_torch.core.config import ModelConfig
from specdec_tpu_torch.core.cache import KVCache
from specdec_tpu_torch.core.model import forward_full, forward_step, init_params
