from gymfx_tpu_torch.data.feed import (
    Frame,
    MarketData,
    MarketDataset,
    load_dataframe,
    load_market_dataset,
)

__all__ = ["Frame", "MarketData", "MarketDataset", "load_dataframe", "load_market_dataset"]
