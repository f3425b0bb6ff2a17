from .n2n import n2n_regularized_loss
from .pixel import l1_loss, l2_loss

__all__ = ["l1_loss", "l2_loss", "n2n_regularized_loss"]
