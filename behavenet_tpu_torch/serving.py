"""Serve a fitted conv autoencoder or neural decoder from an
experiment-store version.

The port's counterpart of the autoencoder and decoder heads of
``behavenet_tpu/serving.py`` for ``model_class`` ``'ae'``, ``'vae'``,
``'beta-tcvae'``, ``'ps-vae'`` and ``'msps-vae'``, and the seven decoder classes
(``'neural-ae'``, ... , ``'arhmm-neural'``; MLP or LSTM).
Where the JAX package exports StableHLO artifacts, the port loads the
version the JAX CLI wrote (``meta_tags.pkl`` and ``best_val_model.pt``) and
runs the model on the GPU, its convolutions in the hand-written kernels::

    from behavenet_tpu_torch import serving
    bundle = serving.load_version('/results/.../version_3')   # on 'cuda'
    latents = bundle.encode(frames_u8)          # (N, H, W, C) uint8, any N
    recon = bundle.reconstruct(frames_u8)       # float32 in [0, 1]

Both heads take raw uint8 frames (numpy or torch, NHWC) and return float32
tensors on the bundle's device, as the JAX heads do (serving.py:80-114). A
VAE-family model serves at its posterior mean (``use_mean=True``): ``encode``
returns mu (``[y, w]`` for the PS-VAE, ``[z_s, z_b, z_u]`` for the
MSPS-VAE) and ``reconstruct`` decodes it. A
decoder's bundle has one head, ``predict``: a (T, input_size) float32 trial
(neural activity, or latents, labels or one-hot states) to its (T,
output_size) predictions (JAX serving.py:177-186)::

    bundle = serving.load_version('/results/.../neural-ae/.../version_0')
    latents_hat = bundle.predict(neural)        # (T, n_neurons) float32
"""

import os
import pickle

import torch

from behavenet_tpu_torch.models import MODELS, Decoder, base
from behavenet_tpu_torch.utils.device import resolve_device
from behavenet_tpu_torch.utils.weights import params_to_state_dict

__all__ = ['load_version', 'ServingBundle', 'DecoderBundle']


class ServingBundle:
    """A loaded model's inference heads."""

    def __init__(self, model, device):
        self.model = model
        self.device = device
        hp = model.hparams
        self.frame_shape = (int(hp['y_pixels']), int(hp['x_pixels']),
                            int(hp['n_input_channels']))

    def names(self):
        return ['encode', 'reconstruct']

    def _frames(self, frames):
        x = torch.as_tensor(frames)
        if x.dtype != torch.uint8 or x.dim() != 4 or \
                tuple(x.shape[1:]) != self.frame_shape:
            raise ValueError('frames must be uint8 of shape (N,) + %s, got %s %s'
                             % (self.frame_shape, x.dtype, tuple(x.shape)))
        return x.to(self.device).contiguous()

    def encode(self, frames):
        """uint8 (N, H, W, C) frames -> float32 (N, n_latents) latents."""
        with torch.inference_mode():
            return self.model.latents(self._frames(frames))

    def reconstruct(self, frames):
        """uint8 (N, H, W, C) frames -> float32 (N, H, W, C) in [0, 1]."""
        with torch.inference_mode():
            return self.model.reconstruct(self._frames(frames))


class DecoderBundle:
    """A loaded decoder's inference head."""

    def __init__(self, model, device):
        self.model = model
        self.device = device
        self.input_size = int(model.hparams['input_size'])

    def names(self):
        return ['predict']

    def predict(self, x):
        """float32 (T, input_size) -> float32 (T, output_size) predictions."""
        x = torch.as_tensor(x)
        if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != self.input_size:
            raise ValueError('predictors must be float32 of shape (T, %d), got %s %s'
                             % (self.input_size, x.dtype, tuple(x.shape)))
        with torch.inference_mode():
            return self.model.predict(x.to(self.device).contiguous())


def load_version(version_dir, device=None):
    """Load a fitted version (``meta_tags.pkl`` + ``best_val_model.pt``, as
    the JAX CLI writes them) onto ``device`` (default ``'cuda'``): a
    :class:`ServingBundle` for the autoencoder family, a
    :class:`DecoderBundle` for a decoder."""
    dev = resolve_device(device)
    with open(os.path.join(version_dir, 'meta_tags.pkl'), 'rb') as f:
        hparams = pickle.load(f)
    if hparams.get('model_class') not in MODELS:
        raise NotImplementedError('serving model_class=%r is not ported yet'
                                  % hparams.get('model_class'))
    model = MODELS[hparams['model_class']](hparams)
    params, _ = base.load_params(os.path.join(version_dir, 'best_val_model.pt'))
    model.load_state_dict(params_to_state_dict(model, params))
    bundle = DecoderBundle if isinstance(model, Decoder) else ServingBundle
    return bundle(model.to(dev).eval(), dev)
