from specdec_tpu_torch.sampling.processors import (
    LogitsProcessor,
    GreedyProcessor,
    MultinomialProcessor,
    TopKProcessor,
    NucleusProcessor,
    TopKNucleusProcessor,
    PerSlotProcessor,
    build_processor,
)
from specdec_tpu_torch.sampling.tree_speculative import (
    TreeTopology, tree_speculative_generate,
)
from specdec_tpu_torch.sampling.eagle_speculative import eagle_generate
from specdec_tpu_torch.sampling.eagle_tree import eagle_tree_generate
