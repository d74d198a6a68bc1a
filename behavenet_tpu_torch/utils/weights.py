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
  (``torch_import.py:144-157``, ``:284-292``).
"""

import numpy as np
import torch

__all__ = ['params_to_state_dict', 'state_dict_to_params', 'arhmm_params_from_jax']


def _chw_to_hwc_perm(c, h, w):
    """Permutation p with flat_hwc[i] = flat_chw[p[i]]."""
    idx = np.arange(c * h * w).reshape(c, h, w)
    return np.transpose(idx, (1, 2, 0)).reshape(-1)


# the encoder's dense heads: reference module name -> JAX layer name
_ENC_HEADS = (('FF', 'fc'), ('logvar', 'logvar'))


def _f32(a):
    return np.asarray(a, dtype=np.float32)


def params_to_state_dict(model, params):
    """State dict (str -> float32 CPU tensor) of ``model`` (a port ``AE``,
    ``VAE``, ``BetaTCVAE`` or ``PSVAE``) from the JAX package's numpy params
    pytree of the same hparams."""
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


def state_dict_to_params(model):
    """The JAX package's numpy params pytree of ``model`` (a port ``AE``):
    the inverse of :func:`params_to_state_dict`, so a checkpoint the port
    writes has the JAX package's layout."""
    hp = model.hparams
    # copies: on the CPU ``.numpy()`` would alias the live parameters, and a
    # later optimizer step would change the returned pytree
    sd = {k: np.array(v.detach().cpu()) for k, v in model.state_dict().items()}
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
