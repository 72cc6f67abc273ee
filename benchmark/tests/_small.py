"""Small sizes at which the benchmark's cells run on the CPU in the tests."""
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SMALL = {"batch": 2, "height": 64, "width": 128}
OVERRIDES = {
    "step2_fp32": {**SMALL, "train_images": 12, "profile_batches": 1},
    "step3_fp32": {**SMALL, "train_images": 12, "profile_batches": 1},
    "eval_fp32": {**SMALL, "val_images": [5, 7, 3], "profile_batches": 2, "sampled_batches": 6},
}
SEED = 2**31 + 98765  # above 32 signed bits, as the check's seeds are
