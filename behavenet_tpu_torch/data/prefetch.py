"""Background-thread batch prefetching for the training loop.

The port's copy of ``behavenet_tpu/data/prefetch.py`` (its single-producer
path; the pooled staging of ``prefetch_workers > 1`` is not ported). The
reference reads each trial synchronously from HDF5 inside the train loop
(data_generator.py:229-323). Here a producer thread stays ``depth`` batches
ahead, so h5py reads overlap with the work queued on the GPU.
"""

import queue
import threading

__all__ = ['prefetched']

_SENTINEL = object()


def prefetched(next_fn, n_batches, depth=2):
    """Yield ``next_fn()`` results for ``n_batches`` calls, produced ahead of time.

    ``next_fn`` is called sequentially from a single producer thread, so any
    RNG-stream the underlying generator consumes is unchanged. Exceptions in
    the producer are re-raised at the consuming site. ``depth=0`` reads
    ahead without bound.
    """
    if n_batches <= 0:
        return
    err = []
    stop = threading.Event()
    q = queue.Queue(maxsize=depth)

    def put(item):
        # bounded put that aborts if the consumer went away, so an early
        # consumer exit (exception / generator close) can never deadlock
        # against a producer blocked on a full queue
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for _ in range(n_batches):
                if stop.is_set():
                    return
                if not put(next_fn()):
                    return
        except BaseException as e:  # re-raised in consumer
            err.append(e)
        finally:
            put(_SENTINEL)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            yield item
    finally:
        stop.set()
        while t.is_alive():
            try:  # drain so a blocked put can complete
                q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=0.1)
    if err:
        raise err[0]
