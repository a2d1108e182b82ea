import sys

from mlsgpu_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
