"""Training loop: AMSGrad train steps, early stopping, metric logging.

The port of ``behavenet_tpu/fitting/training.py`` (single-device branch,
``fit`` at :342-692). Its behaviour follows the reference
(behavenet/fitting/training.py):

- Adam with amsgrad and L2 added to the gradient (:284-286), here
  ``ops.optim.AMSGrad`` (kernel K6 on the GPU);
- epoch 0 is an eval-only pass of the initialized model (:320-322);
- the batching order is reseeded every epoch, ``np.random.seed(rng_train +
  epoch)``, so a run can restart exactly (:327-328);
- validation checks on a precomputed batch schedule with fractional
  ``val_check_interval`` (:302-306);
- the best-val checkpoint (:388-397) and per-trial test rows (:435-447);
- latents (``method='ae'``) or a decoder's predictions (``method='nll'``)
  exported at the end (:452-461).

As in the JAX package, trials are padded up to a multiple of
``shape_bucket`` (32) frames with a ``frame_mask`` that keeps the loss the
unpadded one (except a bidirectional LSTM decoder's: its reversed chain
starts on the padding rows, as in JAX), ``last_checkpoint.pkl`` holds the full training state every
epoch for an exact resume (``resume_version``; the file is the port's own),
and ``warm_start`` maps the initial parameters (a numpy pytree in the JAX
package's layout) to warm-started ones. uint8 frames go to the device as
they are: the first conv and the loss read them as ``x / 255``.

A model with per-epoch loss weights (the VAE family's ``loss_kwargs(epoch)``:
beta, KL and alpha schedules) gets them every epoch, as in JAX (:482). A
variational model draws its eps from one ``torch.Generator`` on the device,
seeded with ``rng_train``, in every step: train, val and test, since the JAX
``eval_step`` samples z too (:569, :596); its state goes into
``last_checkpoint.pkl``, so a resume draws the same eps.

A model with batch norm (``ae_batch_norm``) runs its train steps in train
mode (``model.train()``: batch statistics, the running statistics updated
in the same kernel launch) and every other step in eval mode
(``model.eval()``: the running statistics): val, test and the epoch-0
evals of train batches, as JAX passes ``train=True`` to train steps alone
(:158-235). The running statistics are buffers of the model, so the
best-val snapshot, ``best_val_model.pt`` and ``last_checkpoint.pkl`` carry
them. As in JAX, a padded trial's zero frames enter the batch statistics:
batch norm takes no frame mask.

A multi-session generator (the MSPS-VAE's) serves its train batches as
lists of trials from distinct sessions; each trial is bucketed on its own,
and the padded lengths (``seg_lens``) reach the loss in train steps and in
the epoch-0 eval of train batches, while val and test batches are single
trials without them (JAX :542-600). Within a step the generator draws the
eps first, then one triplet permutation per session.

Not ported yet, and raising ``NotImplementedError``: ``tp_devices``,
``dp_sharding``, ``steps_per_dispatch > 1``, ``prefetch_workers > 1``,
``profile_dir``, optimizers other than AMSGrad.
"""

import os
import pickle
import time

import numpy as np
import torch

from behavenet_tpu_torch.data.prefetch import prefetched
from behavenet_tpu_torch.models import base as models_base
from behavenet_tpu_torch.ops.optim import AMSGrad
from behavenet_tpu_torch.utils.device import resolve_device
from behavenet_tpu_torch.utils.weights import params_to_state_dict, state_dict_to_params

__all__ = ['Logger', 'EarlyStopping', 'fit']


def _scalar(v):
    return v.detach().reshape(()) if isinstance(v, torch.Tensor) else torch.tensor(v)


class Logger(object):
    """Per-epoch metric accumulation feeding metrics.csv rows (JAX:
    training.py:42).

    Metric dicts arrive from the steps as device scalars and are appended
    as they are; they come to the host in one copy per key only when a csv
    row is written, so the steps queue on the GPU without waiting.
    """

    _PREFIX = {'train': 'tr', 'val': 'val', 'test': 'test'}

    def __init__(self, n_datasets=1):
        self.n_datasets = n_datasets
        self._entries = {dtype: [] for dtype in self._PREFIX}

    def reset_metrics(self, dtype):
        self._entries[dtype] = []

    def update_metrics(self, dtype, loss_dict, dataset=None):
        self._entries[dtype].append((dataset, dict(loss_dict)))

    @staticmethod
    def _mean(vals):
        return float(np.mean(torch.stack([_scalar(v) for v in vals]).cpu().numpy()))

    def _means(self, dtype, dataset=None):
        picked = [m for d, m in self._entries[dtype]
                  if dataset is None or d == dataset]
        return {key: self._mean([m[key] for m in picked if key in m])
                for key in {k for m in picked for k in m}}

    def create_metric_row(self, dtype, epoch, batch, dataset, trial, best_epoch=None,
                          by_dataset=False):
        if dtype not in self._PREFIX:
            raise ValueError('%s is an invalid data type' % dtype)
        prefix = self._PREFIX[dtype]
        row = {'epoch': epoch, 'batch': batch, 'trial': trial}
        if dtype == 'val':
            row['best_val_epoch'] = best_epoch
        restrict = dataset if (by_dataset and self.n_datasets > 1) else None
        row['dataset'] = dataset if restrict is not None else -1
        for key, val in self._means(dtype, dataset=restrict).items():
            row['%s_%s' % (prefix, key)] = val
        return row

    def get_loss(self, dtype):
        return self._mean([m['loss'] for _, m in self._entries[dtype]])


class EarlyStopping(object):
    """Patience on the best validation loss, with a minimum-epoch floor
    (JAX: training.py:98; reference training.py:173-242)."""

    def __init__(self, patience=10, min_epochs=10, delta=0):
        self.patience = patience
        self.min_epochs = min_epochs
        self.delta = delta
        self.counter = 0
        self.best_epoch = 0
        self.best_loss = np.inf
        self.stopped_epoch = 0
        self.should_stop = False

    def on_val_check(self, epoch, curr_loss):
        if curr_loss < self.best_loss - self.delta:
            self.best_loss = curr_loss
            self.best_epoch = epoch
            self.counter = 0
        else:
            self.counter += 1
        if epoch > self.min_epochs and self.counter >= self.patience:
            self.stopped_epoch = epoch
            self.should_stop = True
            print('early stop at epoch %i: no val improvement for %i checks '
                  '(best %.6f @ epoch %i, current %.6f)'
                  % (epoch, self.counter, self.best_loss, self.best_epoch, curr_loss))


def _prepare_batch(sample, hparams):
    """A generator sample's model inputs (host side, numpy; JAX: :131): a
    decoder's ``predictors`` and ``targets`` are its input and output
    signals."""
    ins, outs = hparams.get('input_signal'), hparams.get('output_signal')
    if ins in sample and outs in sample:
        return {'predictors': sample[ins], 'targets': sample[outs]}
    return {key: sample[key] for key in ('images', 'masks', 'labels', 'labels_masks')
            if key in sample}


def _bucket_batch(batch, bucket):
    """Pad the frame axis up to the next multiple of ``bucket`` (with zeros,
    integer states too); add frame_mask.

    Few distinct batch shapes for variable-length trials; the masked loss
    is the exact unpadded value, but for a bidirectional LSTM decoder, whose
    reversed chain starts on the zero rows (JAX's padding too).
    """
    n = next(iter(batch.values())).shape[0]
    T = -(-n // bucket) * bucket
    if T == n:
        out = dict(batch)
        out['frame_mask'] = np.ones(n, dtype=np.float32)
        return out
    out = {}
    for key, val in batch.items():
        arr = np.asarray(val)
        pad_width = [(0, T - n)] + [(0, 0)] * (arr.ndim - 1)
        out[key] = np.pad(arr, pad_width)
    fm = np.zeros(T, dtype=np.float32)
    fm[:n] = 1.0
    out['frame_mask'] = fm
    return out


def _collate(data, dataset, hparams):
    """Generator output -> (batch, dataset_idx, seg_lens, trial_idx);
    deterministic and free of shared state (JAX: training.py:308).

    A multi-session batch (a list of samples, the MSPS-VAE's) is the
    dataset-major concatenation of its segments, each bucketed on its own;
    ``seg_lens`` are the padded lengths, and the frame mask drops the pad
    rows out of every loss term, the triplets included. A single-session
    batch has ``seg_lens`` None.
    """
    bucket = hparams.get('shape_bucket', 32)
    if isinstance(data, list):
        parts = []
        for d in data:
            part = {k: np.asarray(d[k]) for k in ('images', 'labels', 'masks', 'labels_masks')
                    if k in d}
            parts.append(_bucket_batch(part, int(bucket)) if bucket else part)
        seg_lens = tuple(int(next(iter(p.values())).shape[0]) for p in parts)
        batch = {k: np.concatenate([p[k] for p in parts], axis=0) for k in parts[0]}
        return batch, dataset, seg_lens, int(data[0]['batch_idx'])
    batch = _prepare_batch(data, hparams)
    if bucket:
        batch = _bucket_batch(batch, int(bucket))
    return batch, dataset, None, int(data['batch_idx'])


def _to_device(batch, device):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def _tree(obj, leaf):
    """Apply ``leaf`` to every tensor / array in nested dicts and lists."""
    if isinstance(obj, dict):
        return {k: _tree(v, leaf) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_tree(v, leaf) for v in obj)
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        return leaf(obj)
    return obj


_UNPORTED = {
    'tp_devices': lambda v: int(v or 0) > 1,
    'dp_sharding': bool,
    'steps_per_dispatch': lambda v: int(v or 1) > 1,
    'prefetch_workers': lambda v: int(v or 1) > 1,
    'profile_dir': bool,
}


def fit(hparams, model, data_generator, exp, method='ae', warm_start=None):
    """Fit a model with AMSGrad + early stopping, logging to the experiment
    store (JAX: training.py:342).

    ``model`` is a port model (``models.aes.AE``, one of ``models.vaes``,
    or with ``method='nll'`` a ``models.decoders.Decoder``); it is moved to
    ``hparams['device']`` (default ``'cuda'``; with no GPU this raises
    unless the device is ``'cpu'``) and holds the best-val weights at the
    end. ``warm_start``, if given, maps the initial parameters (numpy
    pytree, JAX layout) to warm-started ones (``models.aes.load_pretrained_ae``).
    Returns the best-val parameters as such a pytree.
    """
    for key, unported in _UNPORTED.items():
        if unported(hparams.get(key)):
            raise NotImplementedError('%s=%r is not ported yet'
                                      % (key, hparams.get(key)))
    if method not in ('ae', 'nll'):
        raise NotImplementedError('fit method "%s" is not ported yet' % method)
    if hparams.get('optimizer', 'amsgrad') != 'amsgrad':
        raise NotImplementedError('optimizer "%s" is not ported yet' % hparams['optimizer'])
    device = resolve_device(hparams.get('device'))

    if warm_start is not None:
        params = warm_start(state_dict_to_params(model))
        model.load_state_dict(params_to_state_dict(model, params))
    model.to(device)
    optimizer = AMSGrad(model.parameters(), lr=hparams['learning_rate'],
                        weight_decay=hparams.get('l2_reg', 0) or 0)

    def train_step(batch, loss_kwargs):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss, metrics = model.loss_fn(batch, **loss_kwargs)
        loss.backward()
        optimizer.step()
        return metrics

    def eval_step(batch, loss_kwargs):
        model.eval()
        with torch.no_grad():
            return model.loss_fn(batch, **loss_kwargs)[1]

    logger = Logger(n_datasets=data_generator.n_datasets)
    if hparams['enable_early_stop']:
        early_stop = EarlyStopping(
            patience=hparams['early_stop_history'], min_epochs=hparams['min_n_epochs'])
    else:
        early_stop = None

    best_val_loss = np.inf
    best_val_epoch = None
    best_state = None
    n_train = data_generator.n_tot_batches['train']
    val_check_batch = np.append(
        hparams['val_check_interval'] * n_train *
        np.arange(1, int((hparams['max_n_epochs'] + 1) / hparams['val_check_interval'])),
        [n_train * hparams['max_n_epochs'],
         n_train * (hparams['max_n_epochs'] + 1)]).astype('int')

    if hparams.get('rng_seed_train', None) is None:
        rng_train = np.random.randint(0, 10000)
    else:
        rng_train = int(hparams['rng_seed_train'])

    # the eps of every step of a variational model (JAX: training.py:434)
    eps_generator = torch.Generator(device=device) if getattr(model, 'variational', False) \
        else None
    if eps_generator is not None:
        eps_generator.manual_seed(rng_train)

    def step_kwargs(epoch):
        kw = model.loss_kwargs(epoch) if hasattr(model, 'loss_kwargs') else {}
        return kw if eps_generator is None else dict(kw, generator=eps_generator)

    expt_dir = os.path.join(hparams['expt_dir'], 'version_%i' % exp.version)
    model_class = hparams['model_class']

    def save_model(filepath):
        models_base.save_params(state_dict_to_params(model), filepath,
                                extra={'model_class': model_class})

    def snapshot():
        return {k: v.detach().clone() for k, v in model.state_dict().items()}

    # full training state each epoch: with the per-epoch reseeds, a resume
    # continues exactly where the run stopped
    ckpt_file = os.path.join(expt_dir, 'last_checkpoint.pkl')
    start_epoch = 0
    best_model_saved = False
    if hparams.get('resume_version') is not None and os.path.exists(ckpt_file):
        with open(ckpt_file, 'rb') as f:
            ckpt = pickle.load(f)
        model.load_state_dict(_tree(ckpt['model'], torch.from_numpy))
        optimizer.load_state_dict(_tree(ckpt['optimizer'], torch.from_numpy))
        rng_train = ckpt['rng_train']
        if eps_generator is not None:
            eps_generator.set_state(torch.from_numpy(ckpt['generator']))
        best_val_loss = ckpt['best_val_loss']
        best_val_epoch = ckpt['best_val_epoch']
        start_epoch = ckpt['epoch'] + 1
        best_file = os.path.join(expt_dir, 'best_val_model.pt')
        if os.path.exists(best_file):
            params, _ = models_base.load_params(best_file)
            best_state = {k: v.to(device)
                          for k, v in params_to_state_dict(model, params).items()}
            best_model_saved = True
        print('resuming from epoch %i' % start_epoch)

    i_epoch = 0
    for i_epoch in range(start_epoch, hparams['max_n_epochs'] + 1):
        # epoch 0 evaluates the initialized model (reference :320-322)
        np.random.seed(rng_train + i_epoch)  # restartable batching order
        logger.reset_metrics('train')
        data_generator.reset_iterators('train')
        loss_kwargs = step_kwargs(i_epoch)

        t_epoch = time.perf_counter()
        n_frames_epoch = 0
        train_iter = prefetched(
            lambda: data_generator.next_batch('train'), n_train,
            depth=int(hparams.get('prefetch_depth', 2)))
        for i_train, (data, dataset) in enumerate(train_iter):
            will_log = (i_train + 1) % n_train == 0
            will_val = np.any((i_train + 1) + i_epoch * n_train == val_check_batch)
            if data is not None:
                batch, ds, seg_lens, _ = _collate(data, dataset, hparams)
                batch = _to_device(batch, device)
                kw = loss_kwargs if seg_lens is None else dict(loss_kwargs, seg_lens=seg_lens)
                step = train_step if i_epoch > 0 else eval_step
                logger.update_metrics('train', step(batch, kw),
                                      dataset=0 if isinstance(ds, list) else ds)
                n_frames_epoch += int(next(iter(batch.values())).shape[0])

            # per-session rows follow single-session batches only (JAX :579-581)
            if will_log:
                exp.log(logger.create_metric_row(
                    'train', i_epoch, i_train, -1, trial=-1,
                    by_dataset=False, best_epoch=best_val_epoch))
                if data_generator.n_datasets > 1 and isinstance(dataset, int):
                    for d in range(data_generator.n_datasets):
                        exp.log(logger.create_metric_row(
                            'train', i_epoch, i_train, d, trial=-1,
                            by_dataset=True, best_epoch=best_val_epoch))
                exp.save()

            if will_val:
                logger.reset_metrics('val')
                data_generator.reset_iterators('val')
                for _ in range(data_generator.n_tot_batches['val']):
                    data_v, d_val = data_generator.next_batch('val')
                    batch, ds, _, _ = _collate(data_v, d_val, hparams)
                    logger.update_metrics(
                        'val', eval_step(_to_device(batch, device), loss_kwargs), dataset=ds)

                if logger.get_loss('val') < best_val_loss:
                    best_val_loss = logger.get_loss('val')
                    save_model(os.path.join(expt_dir, 'best_val_model.pt'))
                    best_model_saved = True
                    best_state = snapshot()
                    best_val_epoch = i_epoch

                exp.log(logger.create_metric_row(
                    'val', i_epoch, i_train, -1, trial=-1,
                    by_dataset=False, best_epoch=best_val_epoch))
                if data_generator.n_datasets > 1 and isinstance(dataset, int):
                    for d in range(data_generator.n_datasets):
                        exp.log(logger.create_metric_row(
                            'val', i_epoch, i_train, d, trial=-1,
                            by_dataset=True, best_epoch=best_val_epoch))
                exp.save()

        dt = time.perf_counter() - t_epoch
        if i_epoch > 0 and dt > 0:
            print('epoch %03i/%03i: %.2fs, %.0f frames/sec' % (
                i_epoch, hparams['max_n_epochs'], dt, n_frames_epoch / dt))

        interval = int(hparams.get('checkpoint_interval', 1) or 0)
        if interval and i_epoch % interval == 0:
            with open(ckpt_file, 'wb') as f:
                pickle.dump({
                    'model': _tree(model.state_dict(), lambda t: t.detach().cpu().numpy()),
                    'optimizer': _tree(optimizer.state_dict(),
                                       lambda t: t.detach().cpu().numpy()),
                    'rng_train': rng_train,
                    'generator': None if eps_generator is None
                    else eps_generator.get_state().numpy(),
                    'epoch': i_epoch,
                    'best_val_loss': best_val_loss,
                    'best_val_epoch': best_val_epoch,
                }, f)

        if hparams['enable_early_stop']:
            early_stop.on_val_check(i_epoch, logger.get_loss('val'))
            if early_stop.should_stop:
                break

    if not best_model_saved:
        save_model(os.path.join(expt_dir, 'best_val_model.pt'))
        best_state = snapshot()

    if hparams.get('save_last_model', False):
        save_model(os.path.join(expt_dir, 'last_model.pt'))
    model.load_state_dict(best_state)

    # test metrics, logged per trial (reference :435-447)
    data_generator.reset_iterators('test')
    loss_kwargs = step_kwargs(i_epoch)
    for i_test in range(data_generator.n_tot_batches['test']):
        data, dataset = data_generator.next_batch('test')
        batch, ds, _, trial = _collate(data, dataset, hparams)
        logger.reset_metrics('test')
        logger.update_metrics('test', eval_step(_to_device(batch, device), loss_kwargs),
                              dataset=ds)
        exp.log(logger.create_metric_row(
            'test', i_epoch, i_test, ds, trial=trial, by_dataset=True))
    exp.save()

    if method == 'ae' and hparams.get('export_latents', False):
        print('exporting latents')
        from behavenet_tpu_torch.fitting.eval import export_latents
        export_latents(data_generator, model, version=exp.version,
                       expt_dir=hparams['expt_dir'])
    elif method == 'nll' and hparams.get('export_predictions', False):
        print('exporting predictions')
        from behavenet_tpu_torch.fitting.eval import export_predictions
        export_predictions(data_generator, model, version=exp.version,
                           expt_dir=hparams['expt_dir'])

    return state_dict_to_params(model)
