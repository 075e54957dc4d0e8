"""Version metadata (counterpart of the reference's ``version.py``)."""

__version__ = "0.1.0"

# Version of the reference system whose capability surface we track.
REFERENCE_VERSION = "2.1.0"
