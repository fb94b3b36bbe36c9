"""``python -m isotope_tpu_torch`` runs the command-line interface."""
import sys

from isotope_tpu_torch.cli import main

sys.exit(main())
