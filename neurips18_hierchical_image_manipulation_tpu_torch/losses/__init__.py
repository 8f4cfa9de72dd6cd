from .feature_matching import feature_matching_loss
from .gan import discriminator_loss, gan_loss
from .layout import layout_ce_loss, object_mask_loss
from .perceptual import vgg_loss

__all__ = ["gan_loss", "discriminator_loss", "feature_matching_loss", "vgg_loss",
           "layout_ce_loss", "object_mask_loss"]
