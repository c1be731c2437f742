from .dice import dice_focal_loss, dice_loss, focal_loss

__all__ = ["dice_focal_loss", "dice_loss", "focal_loss"]
