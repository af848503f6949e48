"""Command-line entry point (reference: lisflood/main.py:56-226, lisf1.py);
the port of lisflood_tpu/main.py.

Usage:  python -m lisflood_tpu_torch.main settings.xml [flags]
Flags (subset shared with the reference CLI): -q quiet, -v veryquiet,
-l loud, -h noheader, -n nancheck, -i initonly, -s skipvalreplace,
-c checkfiles, -d debug. The run is on the CUDA device; a machine without
one raises.
"""
from __future__ import annotations

import sys

from .config import load_settings
from .models.driver import lisfloodexe

VERSION = "0.1"


def usage():
    print(__doc__)
    sys.exit(1)


def header():
    print(f"LISFLOOD-TPU hydrological model v{VERSION}")
    print("PyTorch/CUDA port of the TPU-native re-implementation of OS-LISFLOOD "
          "(ec-jrc/lisflood-code)")


def main(args=None, device=None):
    """Run the settings file `args[0]` with the flags `args[1:]` (the
    command line's by default) on `device` (None: CUDA)."""
    args = list(sys.argv[1:] if args is None else args)
    if not args:
        usage()
    settings_file = args[0]
    flags = args[1:]
    settings = load_settings(settings_file, sys_args=flags)
    if not settings.flags.get("veryquiet") and not settings.flags.get("quiet"):
        header()
    lisfloodexe(settings, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
