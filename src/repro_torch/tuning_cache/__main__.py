import sys

from repro_torch.tuning_cache.cli import main

if __name__ == "__main__":
    sys.exit(main())
