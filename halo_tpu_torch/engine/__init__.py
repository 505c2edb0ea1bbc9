from .steps import make_forward

__all__ = ["make_forward"]
