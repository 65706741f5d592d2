"""Metadata-event notifications: the five queues and the filer's
notifier pump; the counterpart of seaweedfs_tpu/notification/
(SeaweedFS weed/notification/)."""
from .queues import (LogFileQueue, MemoryQueue, NotificationQueue,
                     attach_notifier, make_queue)

__all__ = ["NotificationQueue", "MemoryQueue", "LogFileQueue",
           "make_queue", "attach_notifier"]
