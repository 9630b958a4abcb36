from .widowx250s import (  # noqa: F401
    WidowX250S,
    WidowX250SBridgeDatasetFlatTable,
    WidowX250SBridgeDatasetSink,
)
