"""Robust input access for flaky network filesystems.

The port's copy of lisflood_tpu/utils/retry.py: the analogue of the
reference's iterative open helpers (zusatz.py:407-451 iterOpenNetcdf/iterReadPCRasterMap/remoteInputAccess):
an open/read that fails with an OS-level error is retried up to
MAX_READ_TRIALS times with READ_PAUSE seconds between attempts; a missing
file under a reachable root fails fast as a LisfloodFileError.
"""
from __future__ import annotations

import errno
import os
import time

from .errors import LisfloodFileError

MAX_READ_TRIALS = int(os.environ.get("LISFLOOD_MAX_READ_TRIALS", "100"))
READ_PAUSE = float(os.environ.get("LISFLOOD_READ_PAUSE", "0.1"))

# errnos that plausibly indicate a transient network/filesystem outage;
# anything else on an EXISTING file (e.g. a truncated HDF5 raising a plain
# OSError from h5py) is a real parse/data error and is re-raised immediately
_TRANSIENT_ERRNOS = frozenset({
    errno.EIO, errno.ENXIO, errno.EAGAIN, errno.EBUSY, errno.ENODEV,
    errno.ECOMM, errno.ESTALE, errno.ENETDOWN, errno.ENETUNREACH,
    errno.ENETRESET, errno.ECONNABORTED, errno.ECONNRESET, errno.ETIMEDOUT,
    errno.ECONNREFUSED, errno.EHOSTDOWN, errno.EHOSTUNREACH, errno.EREMOTEIO,
})


def remote_input_access(function, file_path, error_msg=""):
    """Call `function(file_path)`, retrying transient I/O errors.

    Fail-fast rules (reference zusatz.py:441-443): if the filesystem root
    is reachable but the file does not exist, this is a configuration
    error, not a network outage — raise immediately; likewise an error on
    an existing, reachable file with a non-transient errno (a corrupt or
    truncated file) re-raises the ORIGINAL exception instead of burning
    MAX_READ_TRIALS and masking it behind a network message."""
    file_path = str(file_path)
    root = os.path.sep.join(file_path.split(os.path.sep)[:4])
    num_trials = 1
    while True:
        try:
            obj = function(file_path)
            if num_trials > 1:
                print(f"File {file_path} successfully accessed after {num_trials} attempts")
            return obj
        except (IOError, OSError) as e:
            if os.path.exists(root) and not os.path.exists(file_path):
                raise LisfloodFileError(file_path, error_msg) from e
            if (os.path.exists(file_path)
                    and getattr(e, "errno", None) not in _TRANSIENT_ERRNOS):
                raise
            if num_trials >= MAX_READ_TRIALS:
                raise IOError(
                    f"Cannot access file {file_path}!\n"
                    f"Network down for too long OR bad root directory {root}!") from e
            num_trials += 1
            print(f"Trying to access file {file_path}: attempt n. {num_trials}")
            time.sleep(READ_PAUSE)
