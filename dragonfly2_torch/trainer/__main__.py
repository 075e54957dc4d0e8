"""`python -m dragonfly2_torch.trainer` — the trainer binary (upstream
cmd/trainer/main.go)."""

import sys

from dragonfly2_torch.cli.runner import main_with_config
from dragonfly2_torch.trainer.server import build

if __name__ == "__main__":
    sys.exit(main_with_config("trainer", build))
