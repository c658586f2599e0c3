import sys

from repro_torch.tuning.cli import main

sys.exit(main())
