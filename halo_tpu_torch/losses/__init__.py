from .losses import (cross_entropy_loss, local_consistent_loss,
                     negative_learning_loss)

__all__ = ["cross_entropy_loss", "local_consistent_loss",
           "negative_learning_loss"]
