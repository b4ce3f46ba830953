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
