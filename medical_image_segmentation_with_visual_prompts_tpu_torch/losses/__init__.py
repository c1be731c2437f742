from .clustered_prototype import clustered_prototype_loss, draw_jitters
from .contrastive_pair import contrastive_pair_loss
from .dice import dice_focal_loss, dice_loss, focal_loss

__all__ = ["clustered_prototype_loss", "contrastive_pair_loss",
           "dice_focal_loss", "dice_loss", "draw_jitters", "focal_loss"]
