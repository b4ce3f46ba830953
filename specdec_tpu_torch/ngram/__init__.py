"""NASD, the model-free n-gram drafter (counterpart of
``specdec_tpu/ngram``): host stores (``storage``, and ``native`` in C++),
host-store NASD (``assisted``), the device-resident table
(``device_table``) and device NASD (``device_assisted``)."""
from specdec_tpu_torch.ngram.storage import (
    INgramStorage,
    NGramStorage,
    OneLevelNGramStorage,
)
from specdec_tpu_torch.ngram.assisted import (
    batch_ngram_assisted_generate,
    ngram_assisted_speculative_generate,
)
from specdec_tpu_torch.ngram.device_table import (
    DeviceNGramTable,
    init_device_table,
)
from specdec_tpu_torch.ngram.device_assisted import (
    device_ngram_assisted_generate,
    device_ngram_assisted_generate_batch,
)
