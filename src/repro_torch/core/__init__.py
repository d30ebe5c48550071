"""RACE core of the PyTorch port: IR, detection, contraction, analysis,
backend selection, the torch evaluator, the executor cache and ``race()``."""
