"""Conv-AE architecture generation and the layer dimension contract.

Replicates the behavior of the reference architecture generator
(reference: behavenet/models/ae_model_architecture_generator.py): TF-style
'same'/'valid' output-dimension math with asymmetric padding, symmetric
decoder mirroring, random architecture search, handcrafted-arch loading and
the published default architecture.

A copy of ``behavenet_tpu/models/arch.py`` (numpy only), kept in the port
so that it imports nothing of the JAX package; tests hold the two equal.
"""

import copy

import numpy as np

from behavenet_tpu_torch.utils import jsonc

__all__ = [
    'calculate_output_dim', 'get_encoding_conv_block', 'get_decoding_conv_block',
    'get_handcrafted_dims', 'get_possible_arch', 'draw_archs',
    'load_handcrafted_arch', 'load_handcrafted_arches', 'load_default_arch',
    'estimate_model_footprint',
]


def calculate_output_dim(input_dim, kernel, stride, padding_type='same', layer_type='conv'):
    """Output size + (before, after) padding for one spatial dim of a layer.

    Follows TF common_shape_fns semantics, matching the reference
    (ae_model_architecture_generator.py:347-410) so architectures resolve to
    identical shapes.

    Returns
    -------
    (output_dim, before_pad, after_pad)
    """
    if layer_type == 'conv':
        if padding_type == 'same':
            output_dim = (input_dim + stride - 1) // stride
            total_pad = max(0, (output_dim - 1) * stride + kernel - input_dim)
            before_pad = total_pad // 2
            after_pad = total_pad - before_pad
        elif padding_type == 'valid':
            output_dim = (input_dim - kernel) // stride + 1
            before_pad, after_pad = 0, 0
        else:
            raise NotImplementedError('padding type "%s"' % padding_type)
    elif layer_type == 'maxpool':
        if kernel != 2:
            raise NotImplementedError('only maxpool kernel size 2 supported')
        if padding_type == 'same':
            # ceil mode instead of padding
            output_dim = int(np.ceil((input_dim - kernel) / stride + 1))
            before_pad, after_pad = 0, 0
        elif padding_type == 'valid':
            output_dim = (input_dim - kernel) // stride + 1
            before_pad, after_pad = 0, 0
        else:
            raise NotImplementedError('padding type "%s"' % padding_type)
    else:
        raise NotImplementedError('layer type "%s"' % layer_type)
    return int(output_dim), int(before_pad), int(after_pad)


def get_handcrafted_dims(arch, symmetric=True):
    """Fill per-layer output dims + paddings for a handcrafted architecture.

    Mirrors reference get_handcrafted_dims (ae_model_architecture_generator.py:482).
    """
    arch['model_type'] = 'conv'
    arch['ae_encoding_x_dim'] = []
    arch['ae_encoding_y_dim'] = []
    arch['ae_encoding_x_padding'] = []
    arch['ae_encoding_y_padding'] = []

    for i in range(len(arch['ae_encoding_n_channels'])):
        kernel = arch['ae_encoding_kernel_size'][i]
        stride = arch['ae_encoding_stride_size'][i]
        layer_type = arch['ae_encoding_layer_type'][i]
        if i == 0:
            in_y, in_x = arch['ae_input_dim'][1], arch['ae_input_dim'][2]
        else:
            in_y = arch['ae_encoding_y_dim'][i - 1]
            in_x = arch['ae_encoding_x_dim'][i - 1]
        out_x, x0, x1 = calculate_output_dim(
            in_x, kernel, stride, arch['ae_padding_type'], layer_type)
        out_y, y0, y1 = calculate_output_dim(
            in_y, kernel, stride, arch['ae_padding_type'], layer_type)
        if out_x < 1 or out_y < 1:
            raise ValueError(
                'architecture collapses to %ix%i at encoding layer %i '
                '(%s, kernel %i, stride %i, %s padding, input %ix%i); '
                'remove layers or reduce strides' % (
                    out_y, out_x, i, layer_type, kernel, stride,
                    arch['ae_padding_type'], in_y, in_x))
        arch['ae_encoding_x_dim'].append(out_x)
        arch['ae_encoding_y_dim'].append(out_y)
        arch['ae_encoding_x_padding'].append((x0, x1))
        arch['ae_encoding_y_padding'].append((y0, y1))

    if symmetric:
        arch = get_decoding_conv_block(arch)
    else:
        if arch.get('ae_network_type') == 'max_pooling' or \
                any(t == 'unpool' for t in arch.get('ae_decoding_layer_type', [])):
            raise NotImplementedError('asymmetric arch with unpooling not supported')
        arch['ae_decoding_x_dim'] = []
        arch['ae_decoding_y_dim'] = []
        arch['ae_decoding_x_padding'] = []
        arch['ae_decoding_y_padding'] = []
        if arch['ae_padding_type'] != 'same':
            raise NotImplementedError('asymmetric arch requires same padding')
        for i in range(len(arch['ae_decoding_n_channels'])):
            kernel = arch['ae_decoding_kernel_size'][i]
            stride = arch['ae_decoding_stride_size'][i]
            if i == 0:
                in_y = arch['ae_decoding_starting_dim'][1]
                in_x = arch['ae_decoding_starting_dim'][2]
            else:
                in_y = arch['ae_decoding_y_dim'][i - 1]
                in_x = arch['ae_decoding_x_dim'][i - 1]
            out_x = in_x * stride - stride + 1
            total_x = max(0, (in_x - 1) * stride + kernel - out_x)
            x0 = total_x // 2
            x1 = total_x - x0
            out_y = in_y * stride - stride + 1
            total_y = max(0, (in_y - 1) * stride + kernel - out_y)
            y0 = total_y // 2
            y1 = total_y - y0
            arch['ae_decoding_x_dim'].append(out_x)
            arch['ae_decoding_y_dim'].append(out_y)
            arch['ae_decoding_x_padding'].append((x0, x1))
            arch['ae_decoding_y_padding'].append((y0, y1))
    return arch


def get_decoding_conv_block(arch):
    """Construct symmetric decoder block by mirroring the encoder.

    Mirrors reference get_decoding_conv_block (ae_model_architecture_generator.py:271).
    """
    arch['ae_decoding_x_dim'] = []
    arch['ae_decoding_y_dim'] = []
    arch['ae_decoding_x_padding'] = []
    arch['ae_decoding_y_padding'] = []
    arch['ae_decoding_n_channels'] = []
    arch['ae_decoding_kernel_size'] = []
    arch['ae_decoding_stride_size'] = []
    arch['ae_decoding_layer_type'] = []
    arch['ae_decoding_starting_dim'] = [
        arch['ae_encoding_n_channels'][-1],
        arch['ae_encoding_y_dim'][-1],
        arch['ae_encoding_x_dim'][-1]]

    n_enc = len(arch['ae_encoding_n_channels'])
    for src in range(n_enc - 1, -1, -1):
        if src == 0:
            arch['ae_decoding_n_channels'].append(arch['ae_input_dim'][0])
        else:
            arch['ae_decoding_n_channels'].append(arch['ae_encoding_n_channels'][src - 1])
        arch['ae_decoding_kernel_size'].append(arch['ae_encoding_kernel_size'][src])
        arch['ae_decoding_stride_size'].append(arch['ae_encoding_stride_size'][src])
        arch['ae_decoding_x_padding'].append(arch['ae_encoding_x_padding'][src])
        arch['ae_decoding_y_padding'].append(arch['ae_encoding_y_padding'][src])
        if src > 0:
            arch['ae_decoding_y_dim'].append(arch['ae_encoding_y_dim'][src - 1])
            arch['ae_decoding_x_dim'].append(arch['ae_encoding_x_dim'][src - 1])
        else:
            arch['ae_decoding_y_dim'].append(arch['ae_input_dim'][1])
            arch['ae_decoding_x_dim'].append(arch['ae_input_dim'][2])
        if arch['ae_encoding_layer_type'][src] == 'maxpool':
            arch['ae_decoding_layer_type'].append('unpool')
        else:
            arch['ae_decoding_layer_type'].append('convtranspose')

    if arch.get('ae_decoding_last_FF_layer'):
        # final conv keeps 16 channels to limit the FF layer param count
        arch['ae_decoding_n_channels'][-1] = 16
    return arch


def get_encoding_conv_block(arch, opts):
    """Randomly draw encoder layers; mirrors reference get_encoding_conv_block."""
    last_dims = int(np.prod(arch['ae_input_dim']))
    smallest_pix = min(arch['ae_input_dim'][1], arch['ae_input_dim'][2])

    for key in ('x_dim', 'y_dim', 'n_channels', 'kernel_size', 'stride_size',
                'x_padding', 'y_padding', 'layer_type'):
        arch['ae_encoding_' + key] = []

    i_layer = 0
    global_layer = 0
    while last_dims >= opts['max_latents'] and smallest_pix >= 1:
        kernel = int(np.random.choice(opts['possible_kernel_sizes']))
        if arch['ae_network_type'] == 'strides_only':
            stride = int(np.random.choice(
                opts['possible_strides'], p=opts['possible_strides_probs']))
        else:
            stride = 1
        if i_layer == 0:
            in_y, in_x = arch['ae_input_dim'][1], arch['ae_input_dim'][2]
        else:
            in_y = arch['ae_encoding_y_dim'][i_layer - 1]
            in_x = arch['ae_encoding_x_dim'][i_layer - 1]
        out_y, y0, y1 = calculate_output_dim(in_y, kernel, stride, arch['ae_padding_type'], 'conv')
        out_x, x0, x1 = calculate_output_dim(in_x, kernel, stride, arch['ae_padding_type'], 'conv')

        if i_layer == 0:
            floor_ch = arch['ae_input_dim'][0]
        else:
            floor_ch = arch['ae_encoding_n_channels'][i_layer - 1]
        remaining = opts['possible_n_channels'][opts['possible_n_channels'] >= floor_ch]
        if len(remaining) > 1:
            probs = [.75] + [.25 / (len(remaining) - 1)] * (len(remaining) - 1)
        else:
            probs = [1]
        n_channels = int(np.random.choice(remaining, p=probs))

        if n_channels * out_x * out_y >= opts['max_latents'] and min(out_x, out_y) >= 1:
            arch['ae_encoding_n_channels'].append(n_channels)
            arch['ae_encoding_kernel_size'].append(kernel)
            arch['ae_encoding_stride_size'].append(stride)
            arch['ae_encoding_x_dim'].append(out_x)
            arch['ae_encoding_y_dim'].append(out_y)
            arch['ae_encoding_x_padding'].append((x0, x1))
            arch['ae_encoding_y_padding'].append((y0, y1))
            arch['ae_encoding_layer_type'].append('conv')
            i_layer += 1
        else:
            break

        if arch['ae_network_type'] == 'max_pooling':
            kernel = int(np.random.choice(opts['possible_max_pool_sizes']))
            out_y, y0, y1 = calculate_output_dim(
                arch['ae_encoding_y_dim'][i_layer - 1], kernel, kernel,
                arch['ae_padding_type'], 'maxpool')
            out_x, x0, x1 = calculate_output_dim(
                arch['ae_encoding_x_dim'][i_layer - 1], kernel, kernel,
                arch['ae_padding_type'], 'maxpool')
            if n_channels * out_x * out_y >= opts['max_latents'] and min(out_x, out_y) >= 1:
                arch['ae_encoding_n_channels'].append(n_channels)
                arch['ae_encoding_kernel_size'].append(kernel)
                arch['ae_encoding_stride_size'].append(kernel)
                arch['ae_encoding_x_padding'].append((x0, x1))
                arch['ae_encoding_y_padding'].append((y0, y1))
                arch['ae_encoding_x_dim'].append(out_x)
                arch['ae_encoding_y_dim'].append(out_y)
                arch['ae_encoding_layer_type'].append('maxpool')
                i_layer += 1
            else:
                for key in ('n_channels', 'kernel_size', 'stride_size', 'x_padding',
                            'y_padding', 'x_dim', 'y_dim', 'layer_type'):
                    arch['ae_encoding_' + key] = arch['ae_encoding_' + key][:-1]
                break

        last_dims = arch['ae_encoding_n_channels'][-1] * \
            arch['ae_encoding_y_dim'][-1] * arch['ae_encoding_x_dim'][-1]
        smallest_pix = min(arch['ae_encoding_y_dim'][-1], arch['ae_encoding_x_dim'][-1])
        p = opts['prob_stopping'][global_layer]
        if np.random.choice([0, 1], p=[1 - p, p]):
            break
        global_layer += 1

    return arch


def get_possible_arch(input_dim, n_ae_latents, arch_seed=0):
    """Draw one random conv-AE architecture (reference :70)."""
    np.random.seed(arch_seed)
    opts = {
        'possible_kernel_sizes': np.asarray([3, 5, 7, 9]),
        'possible_strides': np.asarray([1, 2]),
        'possible_strides_probs': np.asarray([0.1, 0.9]),
        'possible_max_pool_sizes': np.asarray([2]),
        'possible_n_channels': np.asarray([16, 32, 64, 128, 256, 512]),
        'prob_stopping': np.arange(0, 1, .05),
        'max_latents': 64,
    }
    if n_ae_latents > opts['max_latents']:
        raise ValueError('Number of latents higher than max latents')

    arch = {
        'ae_input_dim': input_dim,
        'model_type': 'conv',
        'n_ae_latents': n_ae_latents,
        'ae_decoding_last_FF_layer': 0,
        'ae_batch_norm': 0,
        'ae_batch_norm_momentum': None,
        'ae_network_type': 'strides_only',
        'ae_padding_type': ['valid', 'same'][np.random.randint(2)],
    }
    arch = get_encoding_conv_block(arch, opts)
    arch = get_decoding_conv_block(arch)
    return arch


def estimate_model_footprint(arch, input_dim, cutoff_size=20):
    """Estimate train-time memory footprint (bytes) of a conv-AE architecture.

    Unlike the reference (which instantiates a torch model,
    ae_model_architecture_generator.py:413), this computes the same quantity
    analytically from the arch dict: float32 params + input + encoder
    activations x2 (sym decoder) x2 (grads) + 20% margin.
    """
    bytes_per = 4
    total = float(np.prod(input_dim)) * bytes_per

    # parameter count (encoder + mirrored decoder + FF layers)
    def conv_params(c_in, c_out, k):
        return c_in * c_out * k * k + c_out

    n_ch = [input_dim[1]] + list(arch['ae_encoding_n_channels'])
    # encoder convs
    c_prev = arch['ae_input_dim'][0]
    for i, lt in enumerate(arch['ae_encoding_layer_type']):
        if lt == 'conv':
            total += conv_params(c_prev, arch['ae_encoding_n_channels'][i],
                                 arch['ae_encoding_kernel_size'][i]) * bytes_per
        c_prev = arch['ae_encoding_n_channels'][i]
    del n_ch
    # decoder convs
    c_prev = arch['ae_decoding_starting_dim'][0]
    for i, lt in enumerate(arch['ae_decoding_layer_type']):
        if lt == 'convtranspose':
            total += conv_params(c_prev, arch['ae_decoding_n_channels'][i],
                                 arch['ae_decoding_kernel_size'][i]) * bytes_per
        c_prev = arch['ae_decoding_n_channels'][i]
    # FF layers (encoder out -> latents, latents -> decoder in)
    last_conv = arch['ae_encoding_n_channels'][-1] * \
        arch['ae_encoding_y_dim'][-1] * arch['ae_encoding_x_dim'][-1]
    n_lat = arch.get('n_ae_latents', 0)
    total += (last_conv * n_lat + n_lat) * bytes_per
    start_conv = int(np.prod(arch['ae_decoding_starting_dim']))
    total += (n_lat * start_conv + start_conv) * bytes_per

    # intermediate activations: values + grads, x2 for symmetric decoder
    batch = input_dim[0]
    for i in range(len(arch['ae_encoding_n_channels'])):
        act = batch * arch['ae_encoding_n_channels'][i] * \
            arch['ae_encoding_y_dim'][i] * arch['ae_encoding_x_dim'][i]
        total += act * bytes_per * 2 * 2
        if total / 1e9 > cutoff_size:
            break

    return total * 1.2


def draw_archs(batch_size, input_dim, n_ae_latents, n_archs=100, check_memory=True,
               mem_limit_gb=5.0):
    """Draw ``n_archs`` unique random architectures (reference :7)."""
    all_archs = []
    trial = 0
    while len(all_archs) < n_archs:
        arch = get_possible_arch(input_dim, n_ae_latents, arch_seed=trial)
        trial += 1
        if check_memory:
            mem_gb = estimate_model_footprint(arch, [batch_size] + list(input_dim)) / 1e9
            if mem_gb > mem_limit_gb:
                continue
            arch['mem_size_gb'] = mem_gb
        if not any(prev == arch for prev in all_archs):
            all_archs.append(arch)
    return all_archs


def load_default_arch():
    """Default conv AE architecture published in Whiteway et al 2021.

    (reference ae_model_architecture_generator.py:707-720)
    """
    return {
        'ae_network_type': 'strides_only',
        'ae_padding_type': 'same',
        'ae_batch_norm': 0,
        'ae_batch_norm_momentum': None,
        'symmetric_arch': 1,
        'ae_encoding_n_channels': [32, 64, 128, 256, 512],
        'ae_encoding_kernel_size': [5, 5, 5, 5, 5],
        'ae_encoding_stride_size': [2, 2, 2, 2, 5],
        'ae_encoding_layer_type': ['conv', 'conv', 'conv', 'conv', 'conv'],
        'ae_decoding_last_FF_layer': 0,
    }


def load_handcrafted_arch(input_dim, n_ae_latents, ae_arch_json, batch_size=None,
                          check_memory=True, mem_limit_gb=10):
    """Load a handcrafted architecture JSON and fill in dims/padding.

    (reference ae_model_architecture_generator.py:595)
    """
    if ae_arch_json is None:
        arch = load_default_arch()
    else:
        try:
            arch = jsonc.load_file(ae_arch_json)
        except FileNotFoundError:
            print('Warning! could not find ae arch defined in %s; using default architecture'
                  % ae_arch_json)
            arch = load_default_arch()

    arch['ae_batch_norm'] = bool(arch.get('ae_batch_norm', 0) == 1)
    arch['n_input_channels'] = input_dim[0]
    arch['y_pixels'] = input_dim[1]
    arch['x_pixels'] = input_dim[2]
    arch['ae_input_dim'] = input_dim
    arch['n_ae_latents'] = n_ae_latents
    arch = get_handcrafted_dims(arch, symmetric=bool(arch.get('symmetric_arch', 1) == 1))

    if check_memory:
        mem_gb = estimate_model_footprint(arch, [batch_size] + list(input_dim)) / 1e9
        if mem_gb > mem_limit_gb:
            raise ValueError('Handcrafted architecture from %s too big for memory' % ae_arch_json)
        arch['mem_size_gb'] = mem_gb
    return arch


def load_handcrafted_arches(input_dim, n_ae_latents, ae_arch_json, batch_size=None,
                            check_memory=True, mem_limit_gb=10):
    """Load handcrafted architectures, one per requested latent count (reference :665)."""
    if isinstance(n_ae_latents, int):
        n_ae_latents = [n_ae_latents]
    elif isinstance(n_ae_latents, str):
        if ',' in n_ae_latents:
            n_ae_latents = [int(v) for v in n_ae_latents.strip('[]').split(',')]
        else:
            n_ae_latents = [int(n_ae_latents)]
    return [
        load_handcrafted_arch(
            input_dim, n, ae_arch_json, batch_size, check_memory, mem_limit_gb)
        for n in n_ae_latents]
