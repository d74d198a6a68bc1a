"""Conv autoencoder (port of ``behavenet_tpu/models/aes.py``).

Covers ``model_type='conv'`` on archs without batch norm, pooling,
per-session io layers or a last FF decoder layer: ``strides_only``, the
published default, in 'same' or 'valid' padding. Other archs raise
``NotImplementedError``.

Activations are NHWC, as in the JAX package. Parameters carry the names and
layouts of the reference's torch modules (``encoding.encoder.conv%i``
(O, I, kh, kw), ``encoding.FF``, ``decoding.FF``,
``decoding.decoder.convtranspose%i`` (I, O, kh, kw)), so a reference-format
state dict, or the output of ``utils/weights.py``, loads with
``load_state_dict``. Both FF layers therefore use the reference's
channel-major (C, H, W) flattening.

A fresh model draws torch's default init from a ``torch.Generator`` seeded
with ``hparams['rng_seed_model']`` (``models/base.py``).
"""

import numpy as np
import torch
import torch.nn as nn

from behavenet_tpu_torch.models import base
from behavenet_tpu_torch.ops import conv as ops
from behavenet_tpu_torch.ops import losses

__all__ = ['ConvEncoder', 'ConvDecoder', 'AE', 'load_pretrained_ae']


def _param(*shape):
    # filled by AE._init_params
    return nn.Parameter(torch.empty(shape))


def _check_supported(hparams):
    if hparams.get('model_type', 'conv') != 'conv':
        raise NotImplementedError('only model_type="conv" is ported')
    unsupported = {
        'ae_batch_norm': 'batch norm', 'fit_sess_io_layers': 'per-session io layers',
        'ae_decoding_last_FF_layer': 'a last FF decoder layer',
        'conditional_encoder': 'a conditional encoder'}
    for key, what in unsupported.items():
        if hparams.get(key):
            raise NotImplementedError('archs with %s are not ported yet' % what)
    types = set(hparams['ae_encoding_layer_type']) | \
        set(hparams['ae_decoding_layer_type'])
    if types - {'conv', 'convtranspose'}:
        raise NotImplementedError('archs with pooling are not ported yet')


class ConvLayer(nn.Module):
    """Strided conv + bias + activation; weight (O, I, kh, kw)."""

    def __init__(self, c_in, c_out, k, stride, pad_y, pad_x, activation):
        super().__init__()
        self.weight = _param(c_out, c_in, k, k)
        self.bias = _param(c_out)
        self.stride, self.pad_y, self.pad_x = stride, tuple(pad_y), tuple(pad_x)
        self.activation = activation

    def forward(self, x):
        return ops.conv2d(x, self.weight.permute(2, 3, 1, 0), self.bias,
                          self.stride, self.pad_y, self.pad_x, self.activation)


class ConvTransposeLayer(nn.Module):
    """Transposed conv + bias + activation; weight (I, O, kh, kw)."""

    def __init__(self, c_in, c_out, k, stride, pad_y, pad_x, out_pad, block,
                 activation):
        super().__init__()
        self.weight = _param(c_in, c_out, k, k)
        self.bias = _param(c_out)
        self.stride, self.pad_y, self.pad_x = stride, tuple(pad_y), tuple(pad_x)
        self.out_pad, self.block = tuple(out_pad), block
        self.activation = activation

    def forward(self, x, act_grad_in_loss=False):
        return ops.conv_transpose2d(
            x, self.weight.permute(2, 3, 0, 1), self.bias, self.stride,
            self.pad_y, self.pad_x, self.out_pad, block=self.block,
            activation=self.activation, act_grad_in_loss=act_grad_in_loss)


class Linear(nn.Module):
    """Dense layer; weight (out, in) as torch stores it."""

    def __init__(self, d_in, d_out):
        super().__init__()
        self.weight = _param(d_out, d_in)
        self.bias = _param(d_out)

    def forward(self, x):
        return ops.linear(x, self.weight.t(), self.bias)


class ConvEncoder(nn.Module):
    """Conv encoder (JAX: models/aes.py:80 ConvEncoder)."""

    def __init__(self, hparams):
        super().__init__()
        n = len(hparams['ae_encoding_n_channels'])
        self.encoder = nn.ModuleDict()
        for i in range(n):
            c_in = hparams['ae_input_dim'][0] if i == 0 \
                else hparams['ae_encoding_n_channels'][i - 1]
            self.encoder['conv%i' % i] = ConvLayer(
                int(c_in), int(hparams['ae_encoding_n_channels'][i]),
                int(hparams['ae_encoding_kernel_size'][i]),
                int(hparams['ae_encoding_stride_size'][i]),
                hparams['ae_encoding_y_padding'][i],
                hparams['ae_encoding_x_padding'][i], 'leaky_relu')
        fc_in = int(hparams['ae_encoding_n_channels'][-1]
                    * hparams['ae_encoding_y_dim'][-1]
                    * hparams['ae_encoding_x_dim'][-1])
        self.FF = Linear(fc_in, int(hparams['n_ae_latents']))

    def forward(self, x):
        """x: (N, H, W, C) float in [0, 1], or uint8 frames -> (N, latents)."""
        for layer in self.encoder.values():
            x = layer(x)
        return self.FF(x.permute(0, 3, 1, 2).reshape(x.shape[0], -1))


class ConvDecoder(nn.Module):
    """Conv decoder mirroring the encoder (JAX: models/aes.py:204 ConvDecoder)."""

    def __init__(self, hparams):
        super().__init__()
        self.starting_dim = tuple(int(v) for v in hparams['ae_decoding_starting_dim'])
        self.FF = Linear(int(hparams['hidden_layer_size']),
                         int(np.prod(self.starting_dim)))
        n = len(hparams['ae_decoding_n_channels'])
        self.decoder = nn.ModuleDict()
        for i in range(n):
            c_in = self.starting_dim[0] if i == 0 \
                else hparams['ae_decoding_n_channels'][i - 1]
            k = int(hparams['ae_decoding_kernel_size'][i])
            s = int(hparams['ae_decoding_stride_size'][i])
            if hparams['ae_padding_type'] == 'valid':
                # output padding restores the exact pre-conv shape
                in_y = int(self.starting_dim[1] if i == 0
                           else hparams['ae_decoding_y_dim'][i - 1])
                in_x = int(self.starting_dim[2] if i == 0
                           else hparams['ae_decoding_x_dim'][i - 1])
                out_pad = (int(hparams['ae_decoding_y_dim'][i]) - ((in_y - 1) * s + k),
                           int(hparams['ae_decoding_x_dim'][i]) - ((in_x - 1) * s + k))
            else:
                out_pad = (0, 0)
            c_out = int(hparams['ae_decoding_n_channels'][i])
            subpixel = hparams.get('subpixel_decoder', True)
            block_mult = int(hparams.get('subpixel_block_mult') or 4)
            block = block_mult * s if (subpixel and s > 1 and c_out <= 4) else None
            self.decoder['convtranspose%i' % i] = ConvTransposeLayer(
                int(c_in), c_out, k, s, hparams['ae_decoding_y_padding'][i],
                hparams['ae_decoding_x_padding'][i], out_pad, block,
                'sigmoid' if i == n - 1 else 'leaky_relu')

    def forward(self, z, act_grad_in_loss=False):
        """z: (N, hidden) -> (N, H, W, C) reconstruction in [0, 1].

        ``act_grad_in_loss``: the loss applies the final sigmoid's derivative
        (see ``ops.conv.conv_transpose2d``)."""
        c, h, w = self.starting_dim
        x = self.FF(z).reshape(z.shape[0], c, h, w).permute(0, 2, 3, 1).contiguous()
        layers = list(self.decoder.values())
        for layer in layers[:-1]:
            x = layer(x)
        return layers[-1](x, act_grad_in_loss=act_grad_in_loss)


class AE(base.BaseModel):
    """Conv autoencoder (JAX: models/aes.py:396 AE, ``model_type='conv'``)."""

    model_class = 'ae'

    def __init__(self, hparams):
        super().__init__()
        _check_supported(hparams)
        self.hparams = dict(hparams)
        self.hparams['hidden_layer_size'] = self.hparams['n_ae_latents']
        self.encoding = ConvEncoder(self.hparams)
        self.decoding = ConvDecoder(self.hparams)
        self._init_params(self.hparams.get('rng_seed_model', 0))

    def _init_params(self, seed):
        """torch's default init (JAX: AE.init), from a generator seeded with
        ``seed``."""
        gen = torch.Generator().manual_seed(int(seed))
        for layer in self.encoding.encoder.values():
            base.init_conv(layer.weight, layer.bias, gen)
        base.init_linear(self.encoding.FF.weight, self.encoding.FF.bias, gen)
        base.init_linear(self.decoding.FF.weight, self.decoding.FF.bias, gen)
        for layer in self.decoding.decoder.values():
            base.init_conv_transpose(layer.weight, layer.bias, gen)

    def encode(self, x):
        return self.encoding(x)

    def forward(self, x):
        """x: (N, H, W, C) float in [0, 1] or uint8 frames ->
        (reconstruction (N, H, W, C), latents (N, n_latents))."""
        z = self.encoding(x)
        return self.decoding(z), z

    def loss_fn(self, batch):
        """Reconstruction MSE of a batch (JAX: models/aes.py:469 loss_fn).

        ``batch``: ``images`` (N, H, W, C) uint8 frames (or floats in
        [0, 1]), optional ``masks`` of the same shape and ``frame_mask``
        (N,) marking the real frames of a padded batch. Returns (loss,
        {'loss': loss detached}); the final sigmoid's derivative is taken
        in the loss's backward (K5 on the card).
        """
        x = batch['images']
        y = self.decoding(self.encoding(x), act_grad_in_loss=True)
        loss = losses.mse(y, x, batch.get('masks'), batch.get('frame_mask'),
                          sigmoid_output=True)
        return loss, {'loss': loss.detach()}


def _same_shapes(a, b):
    return set(a) == set(b) and all(np.shape(a[k]) == np.shape(b[k]) for k in a)


def load_pretrained_ae(params, model, hparams):
    """Warm-start AE params from a saved checkpoint (JAX: models/aes.py:624;
    reference aes.py:1220-1274).

    ``params`` and the result are numpy pytrees in the JAX package's layout
    (``utils.weights.state_dict_to_params``). The encoder/decoder FF layers
    are dropped when the latent or spatial dims differ between the
    checkpoint and the model.
    """
    path = hparams.get('pretrained_weights_path')
    if hparams['model_type'] == 'linear' and path:
        raise NotImplementedError('Loading pretrained weights with linear AE')
    if hparams['model_type'] != 'conv' or not path:
        print('Initializing with random weights')
        return params

    print('Loading pretrained weights')
    loaded, _ = base.load_params(path)
    same_ff = ('fc' in loaded.get('encoder', {})) and \
        np.shape(loaded['encoder']['fc']['w']) == np.shape(params['encoder']['fc']['w'])

    new = {group: dict(layers) for group, layers in params.items()}
    for group in ('encoder', 'decoder'):
        if group not in loaded:
            continue
        for name, p in loaded[group].items():
            if name in ('fc', 'logvar') and not same_ff:
                print('PRETRAINED MODEL HAS DIFFERENT SPATIAL DIMENSIONS OR N LATENTS: '
                      'NOT LOADING FF PARAMETERS')
                continue
            if name in new[group] and _same_shapes(p, new[group][name]):
                new[group][name] = p
    return new
