"""``python -m triple_hybrid_rag_tpu_torch`` -> the thr-torch CLI."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
