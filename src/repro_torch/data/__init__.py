from repro_torch.data.pipeline import (  # noqa: F401
    DataConfig, SyntheticLM, MemmapCorpus, make_pipeline, Prefetcher,
)
