import sys

from ccv_mppi_path_tracker_tpu_torch.cli import main

sys.exit(main())
