"""In-memory cluster resource model: Peer/Task/Host FSMs + the per-task
peer DAG (counterpart of the reference's ``scheduler/resource``)."""

from dragonfly2_torch.scheduler.resource.host import (
    DEFAULT_CONCURRENT_UPLOAD_LIMIT,
    Host,
    HostType,
)
from dragonfly2_torch.scheduler.resource.managers import (
    GCConfig,
    HostManager,
    PeerManager,
    Resource,
    TaskManager,
)
from dragonfly2_torch.scheduler.resource.peer import (
    PEER_EVENT_DOWNLOAD,
    PEER_EVENT_DOWNLOAD_BACK_TO_SOURCE,
    PEER_EVENT_DOWNLOAD_FAILED,
    PEER_EVENT_DOWNLOAD_SUCCEEDED,
    PEER_EVENT_LEAVE,
    PEER_EVENT_REGISTER_EMPTY,
    PEER_EVENT_REGISTER_NORMAL,
    PEER_EVENT_REGISTER_SMALL,
    PEER_EVENT_REGISTER_TINY,
    PEER_STATE_BACK_TO_SOURCE,
    PEER_STATE_FAILED,
    PEER_STATE_LEAVE,
    PEER_STATE_PENDING,
    PEER_STATE_RECEIVED_EMPTY,
    PEER_STATE_RECEIVED_NORMAL,
    PEER_STATE_RECEIVED_SMALL,
    PEER_STATE_RECEIVED_TINY,
    PEER_STATE_RUNNING,
    PEER_STATE_SUCCEEDED,
    Peer,
)
from dragonfly2_torch.scheduler.resource.task import (
    EMPTY_FILE_SIZE,
    TASK_EVENT_DOWNLOAD,
    TASK_EVENT_DOWNLOAD_FAILED,
    TASK_EVENT_DOWNLOAD_SUCCEEDED,
    TASK_EVENT_LEAVE,
    TASK_STATE_FAILED,
    TASK_STATE_LEAVE,
    TASK_STATE_PENDING,
    TASK_STATE_RUNNING,
    TASK_STATE_SUCCEEDED,
    TINY_FILE_SIZE,
    Piece,
    SizeScope,
    Task,
    TaskType,
)

__all__ = [name for name in dir() if not name.startswith("_")]
