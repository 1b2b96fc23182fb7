"""``python -m paddle_tpu_torch <command>``: the command line (``cli.py``)."""
from .cli import main

raise SystemExit(main())
