from .errors import LisfloodError, LisfloodFileError, LisfloodWarning

__all__ = ["LisfloodError", "LisfloodFileError", "LisfloodWarning"]
