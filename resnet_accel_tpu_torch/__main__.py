import sys

from resnet_accel_tpu_torch.cli import main

sys.exit(main())
