from .monitor import (
    CallbackMonitor,
    CSVMonitor,
    JSONLMonitor,
    MonitorMaster,
    TensorBoardMonitor,
    WandbMonitor,
)

__all__ = ["MonitorMaster", "TensorBoardMonitor", "CSVMonitor", "CallbackMonitor",
           "JSONLMonitor", "WandbMonitor"]
