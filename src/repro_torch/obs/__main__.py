import sys

from repro_torch.obs.cli import main

sys.exit(main())
