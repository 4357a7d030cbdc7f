from gymfx_tpu_torch.config.defaults import DEFAULT_VALUES

__all__ = ["DEFAULT_VALUES"]
