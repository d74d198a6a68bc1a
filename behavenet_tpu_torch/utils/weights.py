"""Carry a JAX-package parameter pytree into the port's state dict, and back;
and a JAX ARHMM's parameters into the port's ARHMM.

The port's copy of the conv-AE half of
``behavenet_tpu/utils/torch_import.py:175 params_to_torch_state_dict``
(which imports ``jax.numpy`` and so cannot be used here). Layouts change as
the reference's torch modules want them:

- conv kernels HWIO -> (O, I, kh, kw); transposed-conv kernels HWIO
  (forward orientation) -> (I, O, kh, kw);
- dense layers (in, out) -> (out, in);
- flattening: the JAX package flattens conv features (H, W, C), torch
  (C, H, W); the input dims of the encoder's FF (and ``logvar``) heads and
  the decoder FF's output dims are permuted accordingly;
- the PS-VAE's fixed maps are stored input-major in JAX and as the
  reference's ``encoding.A.weight`` = A.T (likewise B); its diagonal label
  map ``D`` {'d', 'b'} is ``encoding.D.weight`` / ``.bias``
  (``torch_import.py:144-157``, ``:284-292``);
- a neural decoder's temporal conv ``conv`` (K, in, out) is the reference's
  ``model.decoder.conv1d_layer_00.weight`` (out, in, K), its dense layers
  ``dense_%d`` (in, out) are ``model.decoder.dense_layer_%02i`` (out, in),
  counted from 1 as the reference counts its layers, and ``precision_sqrt``
  (in, d^2) is ``model.precision_sqrt`` (d^2, in).
"""

import numpy as np
import torch

from behavenet_tpu_torch.models.decoders import Decoder

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
    ``VAE``, ``BetaTCVAE``, ``PSVAE`` or ``Decoder``) from the JAX package's
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
    for name in model.encoding.encoder:
        p = enc['conv_%s' % name[len('conv'):]]
        sd['encoding.encoder.%s.weight' % name] = np.transpose(_f32(p['w']), (3, 2, 0, 1))
        sd['encoding.encoder.%s.bias' % name] = _f32(p['b'])

    perm_in = _chw_to_hwc_perm(hp['ae_encoding_n_channels'][-1],
                               hp['ae_encoding_y_dim'][-1],
                               hp['ae_encoding_x_dim'][-1])
    for tname, pname in _ENC_HEADS:
        if hasattr(model.encoding, tname):
            wt = np.empty_like(_f32(enc[pname]['w']).T)      # (n_latents, C*H*W)
            wt[:, perm_in] = _f32(enc[pname]['w']).T
            sd['encoding.%s.weight' % tname] = wt
            sd['encoding.%s.bias' % tname] = _f32(enc[pname]['b'])
    for name in ('A', 'B'):
        if hasattr(model.encoding, name):
            sd['encoding.%s.weight' % name] = _f32(enc[name]).T
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

    for name in model.decoding.decoder:
        p = dec['convt_%s' % name[len('convtranspose'):]]
        sd['decoding.decoder.%s.weight' % name] = np.transpose(_f32(p['w']), (2, 3, 0, 1))
        sd['decoding.decoder.%s.bias' % name] = _f32(p['b'])
    return {k: torch.tensor(v) for k, v in sd.items()}


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
    enc, dec = {}, {}
    for name in model.encoding.encoder:
        enc['conv_%s' % name[len('conv'):]] = {
            'w': np.ascontiguousarray(
                np.transpose(sd['encoding.encoder.%s.weight' % name], (2, 3, 1, 0))),
            'b': sd['encoding.encoder.%s.bias' % name]}

    perm_in = _chw_to_hwc_perm(hp['ae_encoding_n_channels'][-1],
                               hp['ae_encoding_y_dim'][-1],
                               hp['ae_encoding_x_dim'][-1])
    for tname, pname in _ENC_HEADS:
        if hasattr(model.encoding, tname):
            enc[pname] = {
                'w': np.ascontiguousarray(sd['encoding.%s.weight' % tname][:, perm_in].T),
                'b': sd['encoding.%s.bias' % tname]}
    for name in ('A', 'B'):
        if hasattr(model.encoding, name):
            enc[name] = np.ascontiguousarray(sd['encoding.%s.weight' % name].T)
    if hasattr(model.encoding, 'D'):
        enc['D'] = {'d': sd['encoding.D.weight'], 'b': sd['encoding.D.bias']}

    perm_out = _chw_to_hwc_perm(*hp['ae_decoding_starting_dim'])
    dec['fc'] = {'w': np.ascontiguousarray(sd['decoding.FF.weight'][perm_out, :].T),
                 'b': sd['decoding.FF.bias'][perm_out]}
    for name in model.decoding.decoder:
        dec['convt_%s' % name[len('convtranspose'):]] = {
            'w': np.ascontiguousarray(
                np.transpose(sd['decoding.decoder.%s.weight' % name], (2, 3, 0, 1))),
            'b': sd['decoding.decoder.%s.bias' % name]}
    return {'encoder': enc, 'decoder': dec}


def arhmm_params_from_jax(params, device=None):
    """The port ARHMM's ``params`` (float32 tensors on ``device``, ``None``
    meaning ``'cuda'``) from a JAX ARHMM's (``log_pi0``, ``log_Ps``, ``As``,
    ``bs``, ``Sigmas``, ``nus``: numpy arrays, or anything ``np.asarray``
    reads). The two packages lay them out alike."""
    from behavenet_tpu_torch.utils.device import resolve_device
    dev = resolve_device(device)
    return {k: torch.tensor(_f32(v), device=dev) for k, v in params.items()}
