import sys

from mlsgpu_tpu_torch.cli import main

sys.exit(main())
