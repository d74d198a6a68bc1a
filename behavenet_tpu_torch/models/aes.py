"""Conv autoencoder (port of ``behavenet_tpu/models/aes.py``).

Covers ``model_type='conv'`` on archs without per-session io layers or a
last FF decoder layer: ``strides_only`` (the published default) and
``max_pooling``, in 'same' or 'valid' padding, with or without batch norm
(``ae_batch_norm``, its momentum and ``track_running_stats``), in float32.
Other archs, and a ``compute_dtype`` other than float32 or a
``bf16_pipeline``, raise ``NotImplementedError``.

Activations are NHWC, as in the JAX package, and the layers run in its
order: the encoder's conv -> batch norm -> max pool -> leaky ReLU, the
decoder's unpool -> transposed conv -> batch norm (not on the last layer)
-> leaky ReLU or sigmoid. The activation rides in the epilogue of the last
kernel before it (the conv's, the batch norm's or the pool's), never ahead
of a pool: the pool's indices are those of the pre-activation values. The
encoder returns its pool indices, and the decoder takes them. Batch norm
follows ``train()`` / ``eval()``: batch statistics and the running update
in train mode, the running statistics in eval mode, batch statistics in
both without ``track_running_stats`` (JAX: models/aes.py:62 _apply_bn).

Parameters carry the names and layouts of the reference's torch modules
(``encoding.encoder.conv%i`` (O, I, kh, kw), ``encoding.encoder.batchnorm%i``
with its running statistics, ``encoding.FF``, ``decoding.FF``,
``decoding.decoder.convtranspose%i`` (I, O, kh, kw)), so a reference-format
state dict, or the output of ``utils/weights.py``, loads with
``load_state_dict``. The layers of a kind are numbered by their order among
that kind, as the JAX package's exporter numbers them
(``behavenet_tpu/utils/torch_import.py:211-243``); each keeps the JAX
layer's name (``conv_2``, ``bn_2``, ``convt_3``) in ``jax_name``. Both FF
layers use the reference's channel-major (C, H, W) flattening.

A fresh model draws torch's default init from a ``torch.Generator`` seeded
with ``hparams['rng_seed_model']`` (``models/base.py``); batch norm draws
nothing.

The variational encoder of the VAE family (``hparams['variational']``) adds
a ``logvar`` head beside ``FF`` (reference name ``encoding.logvar``, the same
CHW flattening); its models live in ``models/vaes.py``.
"""

import numpy as np
import torch
import torch.nn as nn

from behavenet_tpu_torch.models import base
from behavenet_tpu_torch.ops import conv as ops
from behavenet_tpu_torch.ops import losses

__all__ = ['ConvEncoder', 'ConvDecoder', 'AE', 'load_pretrained_ae', 'r2_score_vw']


def r2_score_vw(y_true, y_pred, weights=None):
    """Variance-weighted multioutput R^2 (sklearn 'variance_weighted'; JAX:
    models/aes.py:32). ``weights`` (B,) or (B, L) restricts the score to
    valid rows / entries (label masks and padded-frame masks)."""
    if weights is None:
        ss_res = torch.sum((y_true - y_pred) ** 2, dim=0)
        ss_tot = torch.sum((y_true - y_true.mean(dim=0)) ** 2, dim=0)
        return 1.0 - ss_res.sum() / torch.clamp(ss_tot.sum(), min=1e-12)
    if weights.dim() == 1:
        weights = weights[:, None]
    w = weights.expand_as(y_true)
    mu = torch.sum(y_true * w, dim=0) / torch.clamp(w.sum(dim=0), min=1e-12)
    ss_res = torch.sum((y_true - y_pred) ** 2 * w)
    ss_tot = torch.sum((y_true - mu) ** 2 * w)
    return 1.0 - ss_res / torch.clamp(ss_tot, min=1e-12)


def _param(*shape):
    # filled by AE._init_params
    return nn.Parameter(torch.empty(shape))


def _check_supported(hparams):
    if hparams.get('model_type', 'conv') != 'conv':
        raise NotImplementedError('only model_type="conv" is ported')
    # the JAX AE casts its convs to compute_dtype (JAX: models/aes.py:89-93,
    # :211-213); the port's conv kernels are float32 only
    if hparams.get('compute_dtype') not in (None, 'float32'):
        raise NotImplementedError('compute_dtype "%s" is not ported yet: the port\'s convs '
                                  'run in float32' % (hparams['compute_dtype'],))
    if hparams.get('bf16_pipeline'):
        raise NotImplementedError('bf16_pipeline is not ported yet: the port keeps its '
                                  'activations in float32')
    unsupported = {
        'fit_sess_io_layers': 'per-session io layers',
        'ae_decoding_last_FF_layer': 'a last FF decoder layer',
        'conditional_encoder': 'a conditional encoder'}
    for key, what in unsupported.items():
        if hparams.get(key):
            raise NotImplementedError('archs with %s are not ported yet' % what)
    types = set(hparams['ae_encoding_layer_type']) | \
        set(hparams['ae_decoding_layer_type'])
    if types - {'conv', 'maxpool', 'convtranspose', 'unpool'}:
        raise NotImplementedError('layer types %s are not ported'
                                  % sorted(types - {'conv', 'maxpool', 'convtranspose',
                                                    'unpool'}))


class ConvLayer(nn.Module):
    """Strided conv + bias + activation; weight (O, I, kh, kw)."""

    def __init__(self, c_in, c_out, k, stride, pad_y, pad_x, activation, jax_name):
        super().__init__()
        self.weight = _param(c_out, c_in, k, k)
        self.bias = _param(c_out)
        self.stride, self.pad_y, self.pad_x = stride, tuple(pad_y), tuple(pad_x)
        self.activation = activation
        self.jax_name = jax_name

    def forward(self, x):
        return ops.conv2d(x, self.weight.permute(2, 3, 1, 0), self.bias,
                          self.stride, self.pad_y, self.pad_x, self.activation)


class ConvTransposeLayer(nn.Module):
    """Transposed conv + bias + activation; weight (I, O, kh, kw)."""

    def __init__(self, c_in, c_out, k, stride, pad_y, pad_x, out_pad, block,
                 activation, jax_name):
        super().__init__()
        self.weight = _param(c_in, c_out, k, k)
        self.bias = _param(c_out)
        self.stride, self.pad_y, self.pad_x = stride, tuple(pad_y), tuple(pad_x)
        self.out_pad, self.block = tuple(out_pad), block
        self.activation = activation
        self.jax_name = jax_name

    def forward(self, x, act_grad_in_loss=False):
        return ops.conv_transpose2d(
            x, self.weight.permute(2, 3, 0, 1), self.bias, self.stride,
            self.pad_y, self.pad_x, self.out_pad, block=self.block,
            activation=self.activation, act_grad_in_loss=act_grad_in_loss)


class BatchNorm(nn.Module):
    """Batch norm over the channels of an NHWC activation, + activation
    (JAX: models/aes.py:62 _apply_bn); weight = gamma, bias = beta and, when
    tracking, the buffers ``running_mean``, ``running_var`` and
    ``num_batches_tracked`` (int64), as torch's BatchNorm2d names them.
    ``momentum`` None means the cumulative average."""

    def __init__(self, ch, momentum, track, activation, jax_name):
        super().__init__()
        self.weight = _param(ch)
        self.bias = _param(ch)
        self.track = bool(track)
        if self.track:
            self.register_buffer('running_mean', torch.zeros(ch))
            self.register_buffer('running_var', torch.ones(ch))
            self.register_buffer('num_batches_tracked', torch.zeros((), dtype=torch.int64))
        self.momentum = momentum
        self.activation = activation
        self.jax_name = jax_name

    def forward(self, x):
        if self.training or not self.track:
            running = (self.running_mean, self.running_var, self.num_batches_tracked) \
                if self.training and self.track else None
            return ops.batch_norm(x, self.weight, self.bias, running=running,
                                  momentum=self.momentum, activation=self.activation)
        return ops.batch_norm(x, self.weight, self.bias, mean=self.running_mean,
                              var=self.running_var, activation=self.activation)


class MaxPool(nn.Module):
    """2x2 / stride-2 max pool (ceil mode for 'same' archs) + activation;
    returns (pooled, indices)."""

    def __init__(self, ceil_mode, activation):
        super().__init__()
        self.ceil_mode, self.activation = bool(ceil_mode), activation

    def forward(self, x):
        return ops.max_pool2d_with_indices(x, self.ceil_mode, self.activation)


class Unpool(nn.Module):
    """Unpool to ``out_hw`` at the matching pool's indices."""

    def __init__(self, out_hw):
        super().__init__()
        self.out_hw = tuple(int(v) for v in out_hw)

    def forward(self, x, indices):
        return ops.max_unpool2d(x, indices, self.out_hw)


class Linear(nn.Module):
    """Dense layer; weight (out, in) as torch stores it."""

    def __init__(self, d_in, d_out):
        super().__init__()
        self.weight = _param(d_out, d_in)
        self.bias = _param(d_out)

    def forward(self, x):
        return ops.linear(x, self.weight.t(), self.bias)


def _batch_norm(hparams, ch, activation, jax_name):
    return BatchNorm(int(ch), hparams.get('ae_batch_norm_momentum', 0.1),
                     hparams.get('track_running_stats', True), activation, jax_name)


class ConvEncoder(nn.Module):
    """Conv encoder (JAX: models/aes.py:80 ConvEncoder)."""

    def __init__(self, hparams):
        super().__init__()
        types = hparams['ae_encoding_layer_type']
        n = len(hparams['ae_encoding_n_channels'])
        bn = bool(hparams.get('ae_batch_norm'))
        self.encoder = nn.ModuleDict()
        count = {'conv': 0, 'batchnorm': 0, 'maxpool': 0}

        def add(kind, layer):
            self.encoder['%s%d' % (kind, count[kind])] = layer
            count[kind] += 1
        for i in range(n):
            if types[i] != 'conv':
                continue
            pool = i < n - 1 and types[i + 1] == 'maxpool'
            c_in = hparams['ae_input_dim'][0] if i == 0 \
                else hparams['ae_encoding_n_channels'][i - 1]
            c_out = int(hparams['ae_encoding_n_channels'][i])
            add('conv', ConvLayer(
                int(c_in), c_out, int(hparams['ae_encoding_kernel_size'][i]),
                int(hparams['ae_encoding_stride_size'][i]),
                hparams['ae_encoding_y_padding'][i], hparams['ae_encoding_x_padding'][i],
                None if (bn or pool) else 'leaky_relu', 'conv_%d' % i))
            if bn:
                add('batchnorm', _batch_norm(hparams, c_out, None if pool else 'leaky_relu',
                                             'bn_%d' % i))
            if pool:
                add('maxpool', MaxPool(hparams['ae_padding_type'] != 'valid', 'leaky_relu'))
        fc_in = int(hparams['ae_encoding_n_channels'][-1]
                    * hparams['ae_encoding_y_dim'][-1]
                    * hparams['ae_encoding_x_dim'][-1])
        self.FF = Linear(fc_in, int(hparams['n_ae_latents']))
        if hparams.get('variational', False):
            self.logvar = Linear(fc_in, int(hparams['n_ae_latents']))

    def forward(self, x):
        """x: (N, H, W, C) float in [0, 1], or uint8 frames -> (latents, pool
        indices), or (mu, logvar, pool indices) for a variational encoder;
        the indices a list in layer order."""
        pool_idx = []
        for layer in self.encoder.values():
            if isinstance(layer, MaxPool):
                x, idx = layer(x)
                pool_idx.append(idx)
            else:
                x = layer(x)
        x = x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)
        if hasattr(self, 'logvar'):
            return self.FF(x), self.logvar(x), pool_idx
        return self.FF(x), pool_idx


class ConvDecoder(nn.Module):
    """Conv decoder mirroring the encoder (JAX: models/aes.py:204 ConvDecoder)."""

    def __init__(self, hparams):
        super().__init__()
        self.starting_dim = tuple(int(v) for v in hparams['ae_decoding_starting_dim'])
        self.FF = Linear(int(hparams['hidden_layer_size']),
                         int(np.prod(self.starting_dim)))
        types = hparams['ae_decoding_layer_type']
        n = len(hparams['ae_decoding_n_channels'])
        bn = bool(hparams.get('ae_batch_norm'))
        self.decoder = nn.ModuleDict()
        count = {'unpool': 0, 'convtranspose': 0, 'batchnorm': 0}

        def add(kind, layer):
            self.decoder['%s%d' % (kind, count[kind])] = layer
            count[kind] += 1
        for i in range(n):
            if types[i] != 'convtranspose':
                continue
            if i > 0 and types[i - 1] == 'unpool':
                add('unpool', Unpool((hparams['ae_decoding_y_dim'][i - 1],
                                      hparams['ae_decoding_x_dim'][i - 1])))
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
            last = i == n - 1
            add('convtranspose', ConvTransposeLayer(
                int(c_in), c_out, k, s, hparams['ae_decoding_y_padding'][i],
                hparams['ae_decoding_x_padding'][i], out_pad, block,
                'sigmoid' if last else (None if bn else 'leaky_relu'), 'convt_%d' % i))
            if bn and not last:
                add('batchnorm', _batch_norm(hparams, c_out, 'leaky_relu', 'bn_%d' % i))

    def forward(self, z, pool_idx=(), act_grad_in_loss=False):
        """z: (N, hidden) and the encoder's pool indices -> (N, H, W, C)
        reconstruction in [0, 1].

        ``act_grad_in_loss``: the loss applies the final sigmoid's derivative
        (see ``ops.conv.conv_transpose2d``)."""
        c, h, w = self.starting_dim
        x = self.FF(z).reshape(z.shape[0], c, h, w).permute(0, 2, 3, 1).contiguous()
        pool_stack = list(pool_idx)
        layers = list(self.decoder.values())
        for layer in layers[:-1]:
            x = layer(x, pool_stack.pop()) if isinstance(layer, Unpool) else layer(x)
        return layers[-1](x, act_grad_in_loss=act_grad_in_loss)


class AE(base.BaseModel):
    """Conv autoencoder (JAX: models/aes.py:396 AE, ``model_type='conv'``)."""

    model_class = 'ae'

    def __init__(self, hparams):
        super().__init__()
        _check_supported(hparams)
        self.hparams = dict(hparams)
        self.hparams['hidden_layer_size'] = self.hparams['n_ae_latents']
        self._build()
        self._init_params(torch.Generator().manual_seed(
            int(self.hparams.get('rng_seed_model', 0))))

    def _build(self):
        self.encoding = ConvEncoder(self.hparams)
        self.decoding = ConvDecoder(self.hparams)

    def _init_params(self, gen):
        """torch's default init (JAX: AE.init), drawn from ``gen`` (a
        generator seeded with ``rng_seed_model``); batch norm's is fixed."""
        for layer in self.encoding.encoder.values():
            if isinstance(layer, ConvLayer):
                base.init_conv(layer.weight, layer.bias, gen)
            elif isinstance(layer, BatchNorm):
                base.init_batch_norm(layer)
        base.init_linear(self.encoding.FF.weight, self.encoding.FF.bias, gen)
        if hasattr(self.encoding, 'logvar'):
            base.init_linear(self.encoding.logvar.weight, self.encoding.logvar.bias, gen)
        base.init_linear(self.decoding.FF.weight, self.decoding.FF.bias, gen)
        for layer in self.decoding.decoder.values():
            if isinstance(layer, ConvTransposeLayer):
                base.init_conv_transpose(layer.weight, layer.bias, gen)
            elif isinstance(layer, BatchNorm):
                base.init_batch_norm(layer)

    def encode(self, x):
        return self.encoding(x)[0]

    def forward(self, x):
        """x: (N, H, W, C) float in [0, 1] or uint8 frames ->
        (reconstruction (N, H, W, C), latents (N, n_latents))."""
        z, pool_idx = self.encoding(x)
        return self.decoding(z, pool_idx), z

    def latents(self, x):
        """The latents a fitted model exports and serves (``encode``)."""
        return self.encode(x)

    def reconstruct(self, x):
        """The reconstruction a fitted model serves."""
        return self(x)[0]

    def loss_fn(self, batch):
        """Reconstruction MSE of a batch (JAX: models/aes.py:469 loss_fn).

        ``batch``: ``images`` (N, H, W, C) uint8 frames (or floats in
        [0, 1]), optional ``masks`` of the same shape and ``frame_mask``
        (N,) marking the real frames of a padded batch. Returns (loss,
        {'loss': loss detached}); the final sigmoid's derivative is taken
        in the loss's backward (K5 on the card).
        """
        x = batch['images']
        z, pool_idx = self.encoding(x)
        y = self.decoding(z, pool_idx, act_grad_in_loss=True)
        loss = losses.mse(y, x, batch.get('masks'), batch.get('frame_mask'),
                          sigmoid_output=True)
        return loss, {'loss': loss.detach()}


def _same_shapes(a, b):
    if isinstance(a, dict) and isinstance(b, dict):
        return set(a) == set(b) and all(_same_shapes(a[k], b[k]) for k in a)
    return not isinstance(a, dict) and not isinstance(b, dict) and \
        np.shape(a) == np.shape(b)


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
