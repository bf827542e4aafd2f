"""``python -m repro_torch.obs --check`` — the observability self-audit."""
import sys

from .check import main

if __name__ == "__main__":
    sys.exit(main())
