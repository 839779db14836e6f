import sys

from dycoreplanet_tpu_torch.cli.main import main

sys.exit(main())
