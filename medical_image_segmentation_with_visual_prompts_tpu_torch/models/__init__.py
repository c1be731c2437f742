from .patch_merging import PatchMerging
from .relative_pe import RelativePE
from .swin_block import ConsecutiveSwinBlocks, SwinTransformerBlock
from .swin_unetr import SwinUnetR
from .unet_blocks import SwinUpBlock
from .window_attention import WindowAttention

__all__ = ["ConsecutiveSwinBlocks", "PatchMerging", "RelativePE",
           "SwinTransformerBlock", "SwinUnetR", "SwinUpBlock",
           "WindowAttention"]
