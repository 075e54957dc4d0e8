"""`python -m dragonfly2_torch.scheduler` — the scheduler binary (upstream
cmd/scheduler/main.go)."""

import sys

from dragonfly2_torch.cli.runner import main_with_config
from dragonfly2_torch.scheduler.server import build

if __name__ == "__main__":
    sys.exit(main_with_config("scheduler", build))
