"""Batched serving on the PyTorch port: prefill + KV/state-cache decode on
a reduced falcon-mamba (SSM: O(1) state per token — the long_500k family).

    PYTHONPATH=src python examples/serve_batch_torch.py          # on cuda
    PYTHONPATH=src python examples/serve_batch_torch.py --device cpu

The port of ``examples/serve_batch.py``.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch import serve  # noqa: E402

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu to run here)")
    args = ap.parse_args()
    serve.main(["--arch", "falcon_mamba_7b", "--reduced", "--batch", "4",
                "--prompt-len", "32", "--gen", "16", "--device",
                args.device])
