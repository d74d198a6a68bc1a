"""Gradients of the port's conv layers against the JAX package's VJPs.

The autograd Functions of ``behavenet_tpu_torch.ops.conv`` run on the CPU
with their plain pieces (the same geometry the CUDA kernels K1, K2 and K4
get on the card) and are held against ``jax.vjp`` of
``behavenet_tpu.ops.conv``. Tolerance: float32, atol 1e-5 * max(1, |ref|)
and rtol 1e-5 (the same products summed in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from behavenet_tpu.ops import conv as jops
from behavenet_tpu_torch.models.aes import AE
from behavenet_tpu_torch.ops import conv as tops
from behavenet_tpu_torch.ops import losses as tlosses


def _close(port, ref):
    port = port.detach().numpy()
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, atol=1e-5 * max(1.0, np.abs(ref).max()),
                               rtol=1e-5)


def _act(x, activation):
    if activation == 'leaky_relu':
        return jops.leaky_relu(x)
    if activation == 'sigmoid':
        return jax.nn.sigmoid(x)
    return x


def _port_grads(fn, x, w, b, gy):
    xt = torch.from_numpy(x).requires_grad_(x.dtype != np.uint8)
    wt = torch.from_numpy(w).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    y = fn(xt, wt, bt)
    y.backward(torch.from_numpy(gy))
    return y, xt.grad, wt.grad, bt.grad


@pytest.mark.parametrize('shape,co,k,s,pad_y,pad_x,act', [
    ((2, 13, 17, 3), 8, 5, 2, (1, 2), (2, 1), 'leaky_relu'),  # asymmetric 'same'
    ((2, 16, 16, 2), 4, 5, 2, (2, 1), (1, 2), None),
    ((2, 10, 10, 6), 5, 5, 5, (0, 0), (0, 0), 'leaky_relu'),  # the arch's stride 5
    ((3, 9, 11, 4), 6, 3, 2, (0, 0), (0, 0), None),           # 'valid', ragged
])
def test_conv2d_grads_match_jax_vjp(shape, co, k, s, pad_y, pad_x, act):
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32)
    w = rng.randn(k, k, shape[-1], co).astype(np.float32)
    b = rng.randn(co).astype(np.float32)
    oh, ow = tops.conv_out_hw(shape[1], shape[2], k, s, pad_y, pad_x)
    gy = rng.randn(shape[0], oh, ow, co).astype(np.float32)
    y, gx, gw, gb = _port_grads(
        lambda xt, wt, bt: tops.conv2d(xt, wt, bt, s, pad_y, pad_x, act), x, w, b, gy)
    ref_y, vjp = jax.vjp(lambda a, c, d: _act(jops.conv2d(a, c, d, s, pad_y, pad_x), act),
                         jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    rgx, rgw, rgb = vjp(jnp.asarray(gy))
    _close(y, ref_y)
    _close(gx, rgx)
    _close(gw, rgw)
    _close(gb, rgb)


def test_conv2d_grads_match_jax_s2dgw_path(monkeypatch):
    """The JAX package's custom-VJP path (``_conv_s2dgw_bwd``, space-to-depth
    grad-w), forced at a small batch as its own tests force it."""
    monkeypatch.setattr(jops, '_S2DGW_MIN_BATCH', 0)
    rng = np.random.RandomState(1)
    x = rng.randn(2, 16, 12, 2).astype(np.float32)
    w = rng.randn(5, 5, 2, 8).astype(np.float32)
    b = rng.randn(8).astype(np.float32)
    gy = rng.randn(2, 8, 6, 8).astype(np.float32)
    _, gx, gw, gb = _port_grads(
        lambda xt, wt, bt: tops.conv2d(xt, wt, bt, 2, (1, 2), (1, 2)), x, w, b, gy)
    _, vjp = jax.vjp(lambda a, c, d: jops.conv2d(a, c, d, 2, (1, 2), (1, 2)),
                     jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    for port, ref in zip((gx, gw, gb), vjp(jnp.asarray(gy))):
        _close(port, ref)


def test_uint8_first_layer_gets_weight_grads_only():
    rng = np.random.RandomState(2)
    x = rng.randint(0, 256, (2, 16, 12, 2)).astype(np.uint8)
    w = rng.randn(5, 5, 2, 8).astype(np.float32)
    b = rng.randn(8).astype(np.float32)
    gy = rng.randn(2, 8, 6, 8).astype(np.float32)
    _, gx, gw, gb = _port_grads(
        lambda xt, wt, bt: tops.conv2d(xt, wt, bt, 2, (1, 2), (1, 2), 'leaky_relu'),
        x, w, b, gy)
    assert gx is None
    _, vjp = jax.vjp(
        lambda c, d: jops.leaky_relu(jops.conv2d(jnp.asarray(x, jnp.float32) / 255.0,
                                                 c, d, 2, (1, 2), (1, 2))),
        jnp.asarray(w), jnp.asarray(b))
    rgw, rgb = vjp(jnp.asarray(gy))
    _close(gw, rgw)
    _close(gb, rgb)


@pytest.mark.parametrize('k,s,pad_y,pad_x,out_pad,block,act', [
    (5, 2, (2, 1), (1, 2), (0, 0), None, 'leaky_relu'),  # asymmetric 'same' crop
    (5, 5, (0, 0), (0, 0), (0, 0), None, 'leaky_relu'),  # the arch's stride 5
    (5, 2, (0, 0), (0, 0), (1, 0), None, None),          # 'valid' output padding
    (3, 2, (1, 1), (1, 1), (1, 1), None, None),
    (5, 2, (1, 2), (1, 2), (0, 0), 8, 'sigmoid'),        # the final layer, block 8
])
def test_conv_transpose2d_grads_match_jax_vjp(k, s, pad_y, pad_x, out_pad, block, act):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 4, 5, 6).astype(np.float32)
    co = 2 if block else 3
    w = rng.randn(k, k, 6, co).astype(np.float32)
    b = rng.randn(co).astype(np.float32)
    oh, ow = tops.conv_transpose_out_hw(4, 5, k, s, pad_y, pad_x, out_pad)
    gy = rng.randn(2, oh, ow, co).astype(np.float32)
    y, gx, gw, gb = _port_grads(
        lambda xt, wt, bt: tops.conv_transpose2d(xt, wt, bt, s, pad_y, pad_x, out_pad,
                                                 block=block, activation=act),
        x, w, b, gy)
    ref_y, vjp = jax.vjp(
        lambda a, c, d: _act(jops.conv_transpose2d(a, c, d, s, pad_y, pad_x, out_pad,
                                                   block=block), act),
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    _close(y, ref_y)
    for port, ref in zip((gx, gw, gb), vjp(jnp.asarray(gy))):
        _close(port, ref)


def test_plain_grad_w_matches_jax_tconv_formula():
    """conv2d_grad_w_plain with the roles swapped and out_transposed is
    _tconv_bwd's grad-w (JAX ops/conv.py:226-233)."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 4, 5, 6).astype(np.float32)
    w = rng.randn(5, 5, 6, 3).astype(np.float32)
    pads, op = ((2, 1), (1, 2)), (0, 0)
    ct = rng.randn(2, 8, 10, 3).astype(np.float32)
    _, gw = jops._tconv_bwd(2, pads[0], pads[1], op, None, None,
                            (jnp.asarray(x), jnp.asarray(w)), jnp.asarray(ct))
    port = tops.conv2d_grad_w_plain(torch.from_numpy(ct), torch.from_numpy(x), 5, 2,
                                    pads[0], pads[1], out_transposed=True)
    _close(port, gw)


def _tiny_ae():
    from behavenet_tpu_torch.models import arch
    a = arch.load_default_arch()
    a['ae_encoding_n_channels'] = [4, 6, 8]
    a['ae_encoding_kernel_size'] = [5, 5, 5]
    a['ae_encoding_stride_size'] = [2, 2, 2]
    a['ae_encoding_layer_type'] = ['conv'] * 3
    a['ae_input_dim'] = [2, 16, 12]
    a['n_ae_latents'] = 3
    a = arch.get_handcrafted_dims(a)
    return AE(dict(a, model_class='ae', model_type='conv', n_ae_latents=3,
                   n_input_channels=2, y_pixels=16, x_pixels=12, rng_seed_model=0))


def _plain_loss(model, batch):
    """The AE's loss through torch autograd of the plain forward pieces."""
    x = batch['images']
    for layer in model.encoding.encoder.values():
        x = tops.conv2d_plain(x, layer.weight.permute(2, 3, 1, 0), layer.bias,
                              layer.stride, layer.pad_y, layer.pad_x, layer.activation)
    z = model.encoding.FF(x.permute(0, 3, 1, 2).reshape(x.shape[0], -1))
    c, h, w = model.decoding.starting_dim
    y = model.decoding.FF(z).reshape(z.shape[0], c, h, w).permute(0, 2, 3, 1)
    for layer in model.decoding.decoder.values():
        y = tops.conv_transpose2d_plain(
            y, layer.weight.permute(2, 3, 0, 1), layer.bias, layer.stride,
            layer.pad_y, layer.pad_x, layer.out_pad, layer.activation)
    return tlosses.mse_plain(y, batch['images'], None, batch['frame_mask'])[0]


def test_kernel_path_has_autograd(monkeypatch):
    """The wrappers a CUDA tensor reaches (routed here to their plain
    versions, as a CPU rehearsal of the card) run inside autograd Functions:
    the model's loss has a grad_fn and its gradients are autograd's of the
    plain forward."""
    called = set()

    def route(name, plain):
        def fn(*args, **kwargs):
            called.add(name)
            kwargs.pop('small_cout', None)
            return plain(*args, **kwargs)
        monkeypatch.setattr(tops, name, fn)

    route('conv2d_cuda', tops.conv2d_plain)
    route('conv_transpose2d_cuda', tops.conv_transpose2d_plain)
    route('conv2d_grad_w_cuda', tops.conv2d_grad_w_plain)
    monkeypatch.setattr(tlosses, 'mse_cuda', lambda *a: (called.add('mse_cuda'),
                                                         tlosses.mse_plain(*a))[1])
    monkeypatch.setattr(tlosses, 'mse_grad_cuda',
                        lambda *a: (called.add('mse_grad_cuda'),
                                    tlosses.mse_grad_plain(*a))[1])
    monkeypatch.setattr(tops, '_on_cpu', lambda x, name='op': False)
    monkeypatch.setattr(tlosses, '_on_cpu', lambda x: False)

    model = _tiny_ae()
    rng = np.random.RandomState(5)
    batch = {'images': torch.from_numpy(rng.randint(0, 256, (4, 16, 12, 2)).astype(np.uint8)),
             'frame_mask': torch.tensor([1.0, 1.0, 1.0, 0.0])}
    loss, _ = model.loss_fn(batch)
    assert loss.grad_fn is not None
    loss.backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    assert called == {'conv2d_cuda', 'conv_transpose2d_cuda', 'conv2d_grad_w_cuda',
                      'mse_cuda', 'mse_grad_cuda'}

    model.zero_grad()
    ref = _plain_loss(model, batch)
    ref.backward()
    np.testing.assert_allclose(loss.item(), ref.item(), rtol=1e-6)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(grads[k].numpy(), p.grad.numpy(), rtol=1e-4,
                                   atol=1e-6 * max(1.0, p.grad.abs().max().item()),
                                   err_msg=k)


def test_grad_w_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match='CUDA'):
        tops.conv2d_grad_w_cuda(torch.zeros(1, 8, 8, 2), torch.zeros(1, 4, 4, 2), 5, 2,
                                (1, 2), (1, 2))
