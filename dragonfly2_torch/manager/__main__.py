"""`python -m dragonfly2_torch.manager` — the manager binary (upstream
cmd/manager/main.go)."""

import sys

from dragonfly2_torch.cli.runner import main_with_config
from dragonfly2_torch.manager.server import build

if __name__ == "__main__":
    sys.exit(main_with_config("manager", build))
