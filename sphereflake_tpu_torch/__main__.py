import sys

from sphereflake_tpu_torch.cli import main

sys.exit(main())
