"""Carry a JAX-package parameter pytree into the port's state dict, and back;
and a JAX ARHMM's parameters into the port's ARHMM.

The port's copy of the conv-AE half of
``behavenet_tpu/utils/torch_import.py:175 params_to_torch_state_dict``
(which imports ``jax.numpy`` and so cannot be used here). Layouts change as
the reference's torch modules want them:

- conv kernels HWIO -> (O, I, kh, kw); transposed-conv kernels HWIO
  (forward orientation) -> (I, O, kh, kw);
- a batch-norm layer's ``gamma``, ``beta`` and, when it tracks them,
  ``running_mean``, ``running_var`` and ``num_batches`` (a float in JAX)
  are ``batchnorm%i.weight``, ``.bias``, ``.running_mean``, ``.running_var``
  and ``.num_batches_tracked`` (int64) (``torch_import.py:74-98``,
  ``:221-243``);
- the layers of a kind are numbered by their order among that kind
  (``conv%i``, ``batchnorm%i``, ``convtranspose%i``), as the exporter's
  code numbers them (``torch_import.py:60-70``, ``:127-132``,
  ``:211-219``); in a pooling arch that is not the JAX layer index
  (``conv_2`` is ``conv1``), so each port layer carries its JAX name;
- dense layers (in, out) -> (out, in);
- flattening: the JAX package flattens conv features (H, W, C), torch
  (C, H, W); the input dims of the encoder's FF (and ``logvar``) heads and
  the decoder FF's output dims are permuted accordingly;
- the PS-VAE's fixed maps are stored input-major in JAX and as the
  reference's ``encoding.A.weight`` = A.T (likewise B, and the MSPS-VAE's
  C, whose trainable bias ``C_b`` is ``encoding.C.bias``); its diagonal
  label map ``D`` {'d', 'b'} is ``encoding.D.weight`` / ``.bias``
  (``torch_import.py:144-157``, ``:284-292``);
- a neural decoder's temporal conv ``conv`` (K, in, out) is the reference's
  ``model.decoder.conv1d_layer_00.weight`` (out, in, K), its dense layers
  ``dense_%d`` (in, out) are ``model.decoder.dense_layer_%02i`` (out, in),
  counted from 1 as the reference counts its layers, and ``precision_sqrt``
  (in, d^2) is ``model.precision_sqrt`` (d^2, in);
- an LSTM decoder's cells ``fwd`` and ``bwd`` keep the JAX layout, ``w``
  (in + h, 4h) as ``model.fwd.weight`` and ``b`` as ``model.fwd.bias``; its
  output layer ``out`` (2h, out) is ``model.out.weight`` (out, 2h), and
  ``precision_sqrt`` as the MLP's.
"""

import numpy as np
import torch

from behavenet_tpu_torch.models.aes import BatchNorm
from behavenet_tpu_torch.models.decoders import LSTM, Decoder

__all__ = ['params_to_state_dict', 'state_dict_to_params', 'arhmm_params_from_jax']


def _chw_to_hwc_perm(c, h, w):
    """Permutation p with flat_hwc[i] = flat_chw[p[i]]."""
    idx = np.arange(c * h * w).reshape(c, h, w)
    return np.transpose(idx, (1, 2, 0)).reshape(-1)


# the encoder's dense heads: reference module name -> JAX layer name
_ENC_HEADS = (('FF', 'fc'), ('logvar', 'logvar'))


def _f32(a):
    return np.asarray(a, dtype=np.float32)


def _decoder_layers(model):
    """(JAX layer name, port module name, transpose of the JAX weight) of
    each layer of a port ``Decoder``."""
    if isinstance(model.model, LSTM):
        out = [(name, 'model.' + name, (0, 1)) for name in ('fwd', 'bwd')
               if hasattr(model.model, name)]
        out.append(('out', 'model.out', (1, 0)))
    else:
        out = []
        for name in model.model.decoder:
            if name.startswith('conv1d'):
                out.append(('conv', 'model.decoder.' + name, (2, 1, 0)))
            else:
                out.append(('dense_%d' % (int(name.split('_')[-1]) - 1),
                            'model.decoder.' + name, (1, 0)))
    if hasattr(model.model, 'precision_sqrt'):
        out.append(('precision_sqrt', 'model.precision_sqrt', (1, 0)))
    return out


def params_to_state_dict(model, params):
    """State dict (str -> float32 CPU tensor) of ``model`` (a port ``AE``,
    ``VAE``, ``BetaTCVAE``, ``PSVAE``, ``MSPSVAE`` or ``Decoder``) from the JAX package's
    numpy params pytree of the same hparams."""
    if isinstance(model, Decoder):
        sd = {}
        for jname, tname, perm in _decoder_layers(model):
            sd[tname + '.weight'] = np.transpose(_f32(params[jname]['w']), perm)
            sd[tname + '.bias'] = _f32(params[jname]['b'])
        return {k: torch.tensor(np.ascontiguousarray(v)) for k, v in sd.items()}
    hp = model.hparams
    enc, dec = params['encoder'], params['decoder']
    sd = {}
    _layers_to_state_dict(sd, 'encoding.encoder', model.encoding.encoder, enc, (3, 2, 0, 1))

    perm_in = _chw_to_hwc_perm(hp['ae_encoding_n_channels'][-1],
                               hp['ae_encoding_y_dim'][-1],
                               hp['ae_encoding_x_dim'][-1])
    for tname, pname in _ENC_HEADS:
        if hasattr(model.encoding, tname):
            wt = np.empty_like(_f32(enc[pname]['w']).T)      # (n_latents, C*H*W)
            wt[:, perm_in] = _f32(enc[pname]['w']).T
            sd['encoding.%s.weight' % tname] = wt
            sd['encoding.%s.bias' % tname] = _f32(enc[pname]['b'])
    for name in ('A', 'B', 'C'):
        if hasattr(model.encoding, name):
            sd['encoding.%s.weight' % name] = _f32(enc[name]).T
    if hasattr(model.encoding, 'C'):
        sd['encoding.C.bias'] = _f32(enc['C_b'])
    if hasattr(model.encoding, 'D'):
        sd['encoding.D.weight'] = _f32(enc['D']['d'])
        sd['encoding.D.bias'] = _f32(enc['D']['b'])

    perm_out = _chw_to_hwc_perm(*hp['ae_decoding_starting_dim'])
    wt = np.empty_like(_f32(dec['fc']['w']).T)      # (C*H*W, hidden)
    wt[perm_out, :] = _f32(dec['fc']['w']).T
    bt = np.empty_like(_f32(dec['fc']['b']))
    bt[perm_out] = _f32(dec['fc']['b'])
    sd['decoding.FF.weight'] = wt
    sd['decoding.FF.bias'] = bt

    _layers_to_state_dict(sd, 'decoding.decoder', model.decoding.decoder, dec, (2, 3, 0, 1))
    return {k: torch.tensor(v) for k, v in sd.items()}


def _layers_to_state_dict(sd, prefix, layers, params, conv_perm):
    """The conv (HWIO weights permuted by ``conv_perm``) and batch-norm
    layers of one half of an AE into ``sd``; pools have no parameters."""
    for name, layer in layers.items():
        if not hasattr(layer, 'jax_name'):
            continue
        p = params[layer.jax_name]
        key = '%s.%s.' % (prefix, name)
        if isinstance(layer, BatchNorm):
            sd[key + 'weight'] = _f32(p['gamma'])
            sd[key + 'bias'] = _f32(p['beta'])
            if layer.track:
                sd[key + 'running_mean'] = _f32(p['running_mean'])
                sd[key + 'running_var'] = _f32(p['running_var'])
                sd[key + 'num_batches_tracked'] = np.int64(np.asarray(p['num_batches']))
        else:
            sd[key + 'weight'] = np.transpose(_f32(p['w']), conv_perm)
            sd[key + 'bias'] = _f32(p['b'])


def _layers_to_params(sd, prefix, layers, conv_perm):
    """The inverse of :func:`_layers_to_state_dict`: JAX name -> leaves."""
    out = {}
    for name, layer in layers.items():
        if not hasattr(layer, 'jax_name'):
            continue
        key = '%s.%s.' % (prefix, name)
        if isinstance(layer, BatchNorm):
            p = {'gamma': sd[key + 'weight'], 'beta': sd[key + 'bias']}
            if key + 'running_mean' in sd:   # absent from gradients
                p['running_mean'] = sd[key + 'running_mean']
                p['running_var'] = sd[key + 'running_var']
                p['num_batches'] = np.asarray(sd[key + 'num_batches_tracked'], np.float32)
        else:
            p = {'w': np.ascontiguousarray(np.transpose(sd[key + 'weight'], conv_perm)),
                 'b': sd[key + 'bias']}
        out[layer.jax_name] = p
    return out


def state_dict_to_params(model, tensors=None):
    """The JAX package's numpy params pytree of ``model``: the inverse of
    :func:`params_to_state_dict`, so a checkpoint the port writes has the
    JAX package's layout. ``tensors`` (name -> tensor, default the model's
    state dict) may be anything keyed like it, e.g. the gradients."""
    hp = model.hparams
    if tensors is None:
        tensors = model.state_dict()
    # copies: on the CPU ``.numpy()`` would alias the live parameters, and a
    # later optimizer step would change the returned pytree
    sd = {k: np.array(v.detach().cpu()) for k, v in tensors.items()}
    if isinstance(model, Decoder):
        return {jname: {'w': np.ascontiguousarray(
                            np.transpose(sd[tname + '.weight'], np.argsort(perm))),
                        'b': sd[tname + '.bias']}
                for jname, tname, perm in _decoder_layers(model)}
    enc = _layers_to_params(sd, 'encoding.encoder', model.encoding.encoder, (2, 3, 1, 0))
    dec = {}

    perm_in = _chw_to_hwc_perm(hp['ae_encoding_n_channels'][-1],
                               hp['ae_encoding_y_dim'][-1],
                               hp['ae_encoding_x_dim'][-1])
    for tname, pname in _ENC_HEADS:
        if hasattr(model.encoding, tname):
            enc[pname] = {
                'w': np.ascontiguousarray(sd['encoding.%s.weight' % tname][:, perm_in].T),
                'b': sd['encoding.%s.bias' % tname]}
    for name in ('A', 'B', 'C'):
        if hasattr(model.encoding, name):
            enc[name] = np.ascontiguousarray(sd['encoding.%s.weight' % name].T)
    if hasattr(model.encoding, 'C'):
        enc['C_b'] = sd['encoding.C.bias']
    if hasattr(model.encoding, 'D'):
        enc['D'] = {'d': sd['encoding.D.weight'], 'b': sd['encoding.D.bias']}

    perm_out = _chw_to_hwc_perm(*hp['ae_decoding_starting_dim'])
    dec['fc'] = {'w': np.ascontiguousarray(sd['decoding.FF.weight'][perm_out, :].T),
                 'b': sd['decoding.FF.bias'][perm_out]}
    dec.update(_layers_to_params(sd, 'decoding.decoder', model.decoding.decoder,
                                 (2, 3, 0, 1)))
    return {'encoder': enc, 'decoder': dec}


def arhmm_params_from_jax(params, device=None, dtype=torch.float32):
    """The port ARHMM's ``params`` (tensors of ``dtype`` on ``device``,
    ``None`` meaning ``'cuda'``; ``torch.float64`` for a float64 model, whose
    parameters then cross unrounded) from a JAX ARHMM's (``log_pi0``,
    ``log_Ps``, ``As``, ``bs``, ``Sigmas``, ``nus``, and with recurrent
    transitions ``Rs`` and ``r``: numpy arrays, or anything ``np.asarray``
    reads). The two packages lay them out alike."""
    from behavenet_tpu_torch.utils.device import resolve_device
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(v), dtype=dtype, device=dev) for k, v in params.items()}
