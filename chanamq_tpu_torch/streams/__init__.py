"""Stream queues: append-only segmented logs with server-tracked cursors.

See streams/queue.py for semantics; selected per queue with
``x-queue-type: stream`` at declare time.
"""

from .groups import (  # noqa: F401
    GROUP_CURSOR_PREFIX,
    GROUP_MODES,
    StreamGroup,
    validate_group_args,
)
from .queue import (  # noqa: F401
    GET_CURSOR,
    VALID_QUEUE_TYPES,
    StreamCursor,
    StreamQueue,
    parse_offset_spec,
)
from .segment import (  # noqa: F401
    Segment,
    StreamRecord,
    pack_records,
    unpack_records,
)
