from .pipeline import DataConfig, ShardedTokenPipeline, synth_corpus  # noqa: F401
