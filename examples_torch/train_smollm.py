"""End-to-end run: train the full 135M smollm-135m for a few hundred
steps on the synthetic token stream, with checkpoints and fault tolerance.

    PYTHONPATH=src python examples_torch/train_smollm.py --steps 300

A thin preset around ``repro_torch.launch.train`` (the port of
``examples/train_smollm.py``), on the CUDA device by default; arguments
after the preset override it (argparse: the last one wins), e.g.
``--reduced --steps 3 --device cpu`` for a CPU run of the reduced config.
"""
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch.train import main  # noqa: E402

if __name__ == "__main__":
    preset = [
        "--arch", "smollm-135m",
        "--steps", "300",
        "--batch", "4",
        "--seq", "256",
        "--lr", "1e-3",
        "--ckpt-dir", os.path.join(tempfile.gettempdir(), "smollm_ckpt"),
        "--ckpt-every", "20",
        "--log-every", "5",
    ]
    main(preset + sys.argv[1:])
