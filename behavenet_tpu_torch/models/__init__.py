"""Models of the port: architecture dicts, checkpoint io, the conv AE, the
VAE family (VAE, beta-TC-VAE, PS-VAE) and the ARHMM (``models.arhmm``)."""

from behavenet_tpu_torch.models.aes import AE, load_pretrained_ae  # noqa
from behavenet_tpu_torch.models.vaes import VAE, BetaTCVAE, PSVAE  # noqa

# model_class -> the port's model: the classes the port fits and serves
MODELS = {'ae': AE, 'vae': VAE, 'beta-tcvae': BetaTCVAE, 'ps-vae': PSVAE}
