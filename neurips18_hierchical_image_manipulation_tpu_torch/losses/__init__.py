from .feature_matching import feature_matching_loss
from .gan import discriminator_loss, gan_loss
from .perceptual import vgg_loss

__all__ = ["gan_loss", "discriminator_loss", "feature_matching_loss", "vgg_loss"]
