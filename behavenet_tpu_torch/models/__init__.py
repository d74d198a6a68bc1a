"""Models of the port: architecture dicts, checkpoint io, the conv AE, the
VAE family (VAE, beta-TC-VAE, PS-VAE), the neural decoders and the ARHMM
(``models.arhmm``)."""

from behavenet_tpu_torch.models.aes import AE, load_pretrained_ae  # noqa
from behavenet_tpu_torch.models.decoders import DECODER_CLASSES, Decoder  # noqa
from behavenet_tpu_torch.models.vaes import VAE, BetaTCVAE, PSVAE  # noqa

# model_class -> the port's model: the classes the port fits and serves (the
# autoencoder family's CLI and latents export take AE_MODELS only)
AE_MODELS = {'ae': AE, 'vae': VAE, 'beta-tcvae': BetaTCVAE, 'ps-vae': PSVAE}
MODELS = dict(AE_MODELS, **{mc: Decoder for mc in DECODER_CLASSES})
