"""Neural decoders: neural activity <-> AE latents, ARHMM states or labels
(the port of ``behavenet_tpu/models/decoders.py``; reference
behavenet/models/decoders.py).

``Decoder`` wraps an ``MLP`` (``model_type`` ``'mlp'``, ``'mlp-mv'``) whose
first layer is a temporal convolution over the whole trial, kernel
``2 n_lags + 1`` with 'same' padding (the +-n_lags window of neural
activity), then dense layers; or an ``LSTM`` (``'lstm'``): a recurrence over
the trial, forward and (``bidirectional``, the default) reversed, then a
dense output layer. The LSTM follows the JAX package's (JAX :130), not the
reference's, which is a stub (behavenet/models/decoders.py:329-353). Four noise
distributions: ``'gaussian'`` (masked MSE, K5 on the card), ``'gaussian-full'``
(a data-dependent precision head ``L L^T`` that the loss takes as a
covariance, as the reference does; K12 on the card), ``'poisson'`` (softplus
rates) and ``'categorical'`` (logits). The loss runs on a lag-trimmed
window and is rescaled as the reference's chunked accumulation
(JAX :224-289).

Parameters carry the reference's module names: ``decoder.conv1d_layer_00``
(weight (out, in, K)), ``decoder.dense_layer_%02i`` (weight (out, in)) and
``precision_sqrt``; the LSTM's are ``fwd`` and ``bwd`` (weight (in + h,
4h) and bias (4h,) in the JAX layout), ``out`` and ``precision_sqrt``
(weight (out, in)). ``utils/weights.py`` maps them to the JAX pytree
(``conv``, ``dense_%d``, ``fwd``, ``bwd``, ``out``, ``precision_sqrt``) and
back. The labels-to-images ``ConvDecoder`` (JAX :292) is not ported yet.
"""

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

from behavenet_tpu_torch.models import base
from behavenet_tpu_torch.models.aes import r2_score_vw
from behavenet_tpu_torch.ops import losses
from behavenet_tpu_torch.ops.lstm import lstm_scan

__all__ = ['MLP', 'LSTM', 'Decoder', 'DECODER_CLASSES', 'NOISE_DISTS']

DECODER_CLASSES = ('neural-ae', 'neural-ae-me', 'ae-neural', 'neural-labels',
                   'labels-neural', 'neural-arhmm', 'arhmm-neural')
NOISE_DISTS = ('gaussian', 'gaussian-full', 'poisson', 'categorical')
_LRELU_SLOPE = 0.05   # JAX :38 (not torch's 0.01)
_ACTIVATIONS = {
    'linear': None,
    'relu': F.relu,
    'lrelu': lambda x: F.leaky_relu(x, _LRELU_SLOPE),
    'sigmoid': torch.sigmoid,
    'tanh': torch.tanh,
}


def _param(*shape):
    # filled by MLP._init_params
    return nn.Parameter(torch.empty(shape))


@contextlib.contextmanager
def _f32_cudnn():
    """cuDNN convolutions accumulate in float32 inside, not in TF32 (PyTorch's
    default, ``torch.backends.cudnn.allow_tf32``), as JAX accumulates the
    temporal conv (JAX :96-102); the other cuDNN flags stay as they are."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class _TemporalConv(torch.autograd.Function):
    """``F.conv1d`` with 'same' padding, its forward and backward both
    under :func:`_f32_cudnn` (autograd runs the backward after the forward
    has returned, so a pin around the forward alone would miss it)."""

    @staticmethod
    def forward(ctx, x, weight, bias, padding):
        ctx.save_for_backward(x, weight)
        ctx.padding = padding
        with _f32_cudnn():
            return F.conv1d(x, weight, bias, padding=padding)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        with _f32_cudnn():
            gx, gw, gb = torch.ops.aten.convolution_backward(
                grad, x, weight, [weight.shape[0]], [1], [ctx.padding], [1], False, [0], 1,
                list(ctx.needs_input_grad[:3]))
        return gx, gw, gb, None


class _Conv1d(nn.Module):
    """Temporal conv over a (T, in) trial, 'same' padding; weight (out, in, K)."""

    def __init__(self, c_in, c_out, n_lags):
        super().__init__()
        self.weight = _param(c_out, c_in, 2 * n_lags + 1)
        self.bias = _param(c_out)
        self.n_lags = n_lags

    def forward(self, x):
        # a cross-correlation, as lax.conv_general_dilated: no flip
        return _TemporalConv.apply(x.t()[None], self.weight, self.bias, self.n_lags)[0].t()


class _Linear(nn.Module):
    """Dense layer; weight (out, in) as torch stores it."""

    def __init__(self, d_in, d_out):
        super().__init__()
        self.weight = _param(d_out, d_in)
        self.bias = _param(d_out)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


def _precision(head, h, d):
    """The precision ``L L^T`` (T, d, d) of the head's L (T, d * d)."""
    L = head(h).reshape(-1, d, d)
    return torch.einsum('tij,tkj->tik', L, L)


class MLP(nn.Module):
    """Temporal conv + dense stack (JAX: models/decoders.py:44 MLP)."""

    def __init__(self, hparams):
        super().__init__()
        self.input_size = int(hparams['input_size'])
        self.output_size = int(hparams['output_size'])
        self.n_hid_layers = int(hparams['n_hid_layers'])
        self.n_hid_units = int(hparams.get('n_hid_units', 0))
        self.n_lags = int(hparams['n_lags'])
        self.noise_dist = hparams['noise_dist']
        self.activation = hparams.get('activation', 'relu')
        if self.activation not in _ACTIVATIONS:
            raise ValueError('"%s" is an invalid activation function' % self.activation)
        conv_out = self.output_size if self.n_hid_layers == 0 else self.n_hid_units
        self.decoder = nn.ModuleDict()
        self.decoder['conv1d_layer_00'] = _Conv1d(self.input_size, conv_out, self.n_lags)
        in_size = conv_out
        for i in range(self.n_hid_layers):
            out_size = self.output_size if i == self.n_hid_layers - 1 else self.n_hid_units
            self.decoder['dense_layer_%02i' % (i + 1)] = _Linear(in_size, out_size)
            in_size = out_size
        if self.noise_dist == 'gaussian-full':
            # the precision head hangs off the input of the last layer (JAX :59-62)
            prec_in = self.input_size if self.n_hid_layers == 0 else self.n_hid_units
            self.precision_sqrt = _Linear(prec_in, self.output_size ** 2)

    def init_params(self, generator):
        """torch's default init (JAX: MLP.init), drawn from ``generator``: the
        conv's fan-in is in * K (JAX :70)."""
        for layer in self.decoder.values():
            fan_in = layer.weight[0].numel()
            base.uniform_fan_in_(layer.weight, fan_in, generator)
            base.uniform_fan_in_(layer.bias, fan_in, generator)
        if hasattr(self, 'precision_sqrt'):
            base.init_linear(self.precision_sqrt.weight, self.precision_sqrt.bias, generator)

    def forward(self, x):
        """x: (T, input_size) -> (predictions (T, output_size), precision
        (T, output_size, output_size) or None)."""
        act_mid = _ACTIVATIONS[self.activation]
        act_final = F.softplus if self.noise_dist == 'poisson' else None
        precision = None
        layers = list(self.decoder.values())
        if hasattr(self, 'precision_sqrt') and self.n_hid_layers == 0:
            precision = _precision(self.precision_sqrt, x, self.output_size)
        h = layers[0](x)
        if self.n_hid_layers == 0:
            return (h if act_final is None else act_final(h)), precision
        if act_mid is not None:
            h = act_mid(h)
        for i, layer in enumerate(layers[1:]):
            last = i == self.n_hid_layers - 1
            if last and hasattr(self, 'precision_sqrt'):
                precision = _precision(self.precision_sqrt, h, self.output_size)
            h = layer(h)
            act = act_final if last else act_mid
            if act is not None:
                h = act(h)
        return h, precision


class _Cell(nn.Module):
    """One LSTM direction's weights in the JAX layout: weight (in + h, 4h),
    rows the input then the hidden units, columns the gate blocks i, f, g,
    o; bias (4h,)."""

    def __init__(self, d_in, h):
        super().__init__()
        self.weight = _param(d_in + h, 4 * h)
        self.bias = _param(4 * h)


class LSTM(nn.Module):
    """The LSTM decoder (JAX: models/decoders.py:130 LSTM): hidden states of
    a forward and, with ``bidirectional`` (default True), a reversed
    recurrence (``ops.lstm.lstm_scan``: K23 / K24 on the card), then a dense
    output layer; (T, input_size) -> (T, output_size)."""

    def __init__(self, hparams):
        super().__init__()
        self.input_size = int(hparams['input_size'])
        self.output_size = int(hparams['output_size'])
        self.n_hid_units = int(hparams.get('n_hid_units', 64))
        self.noise_dist = hparams['noise_dist']
        h = self.n_hid_units
        self.fwd = _Cell(self.input_size, h)
        if bool(hparams.get('bidirectional', True)):
            self.bwd = _Cell(self.input_size, h)
        out_in = 2 * h if hasattr(self, 'bwd') else h
        self.out = _Linear(out_in, self.output_size)
        if self.noise_dist == 'gaussian-full':
            self.precision_sqrt = _Linear(out_in, self.output_size ** 2)

    def cells(self):
        return [self.fwd] + ([self.bwd] if hasattr(self, 'bwd') else [])

    def init_params(self, generator):
        """torch's default init (JAX: LSTM.init), drawn from ``generator``:
        fan-in in + h for each cell's weight and bias (JAX :149-158)."""
        fan_in = self.input_size + self.n_hid_units
        for cell in self.cells():
            base.uniform_fan_in_(cell.weight, fan_in, generator)
            base.uniform_fan_in_(cell.bias, fan_in, generator)
        base.init_linear(self.out.weight, self.out.bias, generator)
        if hasattr(self, 'precision_sqrt'):
            base.init_linear(self.precision_sqrt.weight, self.precision_sqrt.bias, generator)

    def forward(self, x):
        """x: (T, input_size) -> (predictions (T, output_size), precision
        (T, output_size, output_size) or None) (JAX :182-197)."""
        h = lstm_scan(x, *(t for cell in self.cells() for t in (cell.weight, cell.bias)))
        precision = None
        if hasattr(self, 'precision_sqrt'):
            precision = _precision(self.precision_sqrt, h, self.output_size)
        out = self.out(h)
        if self.noise_dist == 'poisson':
            out = F.softplus(out)
        return out, precision


class Decoder(base.BaseModel):
    """Noise-distribution dispatch around the MLP or the LSTM (JAX:
    models/decoders.py:200 Decoder; reference decoders.py:14-152)."""

    model_class = 'neural-decoder'
    metrics_keys = ['loss', 'r2', 'fc']

    def __init__(self, hparams):
        super().__init__()
        self.hparams = dict(hparams)
        mt = hparams['model_type']
        if mt not in ('mlp', 'mlp-mv', 'lstm'):
            raise ValueError('"%s" is not a valid model type' % mt)
        if hparams['noise_dist'] not in NOISE_DISTS:
            raise ValueError('"%s" is not a valid noise dist' % hparams['noise_dist'])
        self.model = (LSTM if mt == 'lstm' else MLP)(self.hparams)
        self.model.init_params(torch.Generator().manual_seed(
            int(self.hparams.get('rng_seed_model', 0))))

    def forward(self, x):
        """x: (T, input_size) -> (predictions, precision or None)."""
        return self.model(x)

    def predict(self, x):
        """The predictions a fitted decoder exports and serves."""
        return self.model(x)[0]

    def loss_fn(self, batch):
        """Loss and metrics of one trial (JAX: models/decoders.py:224
        loss_fn).

        ``batch``: ``predictors`` (T, input_size), ``targets`` (T,
        output_size) floats or (T,) integer states, and optionally
        ``frame_mask`` (T,) marking the real frames of a padded trial; the
        loss then runs over ``[max_lags, n_valid - max_lags)``, else over the
        statically trimmed window. Returns (loss, {'loss', 'r2', 'fc'}
        detached).
        """
        predictors, targets = batch['predictors'], batch['targets']
        fm = batch.get('frame_mask')
        max_lags = int(self.hparams['n_max_lags'])
        T = targets.shape[0]
        noise = self.hparams['noise_dist']
        outputs, precision = self.model(predictors)

        if fm is None:
            out_w = outputs[max_lags:T - max_lags]
            tgt_w = targets[max_lags:T - max_lags]
            w = None
            n_valid = T
        else:
            n_valid = fm.sum()
            t_idx = torch.arange(T, device=fm.device)
            w = ((t_idx >= max_lags) & (t_idx < n_valid - max_lags)).to(outputs.dtype)
            out_w, tgt_w = outputs, targets

        def weighted_mean(v):
            if w is None:
                return v.mean()
            return (v * w).sum() / torch.clamp(w.sum(), min=1.0)

        if noise == 'gaussian':
            raw = losses.mse(out_w, tgt_w, frame_mask=w)
        elif noise == 'gaussian-full':
            cov = precision[max_lags:T - max_lags] if fm is None else precision
            raw = losses.gaussian_neg_log_prob(out_w, tgt_w, cov, frame_mask=w)
        elif noise == 'poisson':
            # torch PoissonNLLLoss(log_input=False, full=False, eps=1e-8)
            raw = weighted_mean((out_w - tgt_w * torch.log(out_w + 1e-8)).mean(dim=1))
        else:  # categorical
            logp = F.log_softmax(out_w, dim=1)
            labels = tgt_w.reshape(-1, 1).long()
            raw = weighted_mean(-torch.take_along_dim(logp, labels, dim=1)[:, 0])

        # reference arithmetic: per-chunk means weighted by window rows / full T
        loss = raw * (n_valid - 2 * max_lags) / n_valid

        zero = torch.zeros((), device=outputs.device)
        if noise in ('gaussian', 'gaussian-full'):
            r2, fc = r2_score_vw(tgt_w, out_w, weights=w), zero
        elif noise == 'categorical':
            correct = (torch.argmax(out_w, dim=1) == tgt_w.reshape(-1)).to(outputs.dtype)
            r2, fc = zero, weighted_mean(correct)
        else:
            r2, fc = zero, zero
        return loss, {'loss': loss.detach(), 'r2': r2.detach(), 'fc': fc.detach()}
