import sys

from mmbench.run import main

sys.exit(main())
