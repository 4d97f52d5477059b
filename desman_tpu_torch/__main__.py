"""``python -m desman_tpu_torch <command> ...``"""
from .cli import main

raise SystemExit(main())
