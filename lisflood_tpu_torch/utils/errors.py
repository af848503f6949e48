"""Error and warning types for the framework.

Mirrors the error surface of the reference (lisflood/global_modules/errors.py:5-53):
a hard model error, a file error carrying the offending path, and a warning class.

The port's copy of lisflood_tpu/utils/errors.py.
"""


class LisfloodError(Exception):
    """Fatal model configuration / runtime error."""

    def __init__(self, msg):
        header = "\n\n ========================== LISFLOOD-TPU ERROR ==========================\n"
        super().__init__(header + str(msg))
        self.msg = msg


class LisfloodFileError(LisfloodError):
    """A required input file is missing or unreadable."""

    def __init__(self, filename, msg=""):
        super().__init__(f"{msg}\nMissing or unreadable input file: {filename}")
        self.filename = filename


class LisfloodWarning(Warning):
    """Non-fatal configuration or data warning."""

    def __init__(self, msg):
        super().__init__(msg)
        self.msg = msg
