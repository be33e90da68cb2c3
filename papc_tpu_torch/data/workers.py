"""Sample preparation in worker processes (counterpart of
``papc_tpu/data/workers.py``).

- The ``spawn`` start method: a forked child of a process that holds a
  CUDA context cannot use CUDA, and fork after threads have started can
  deadlock.
- The dataset goes to each worker once, through the pool's initializer
  (a global in the worker), not with every task. It travels as the path
  of one pickle file that the pool writes: a spawned child reads its
  process object (initializer arguments included) from a pipe only
  after it has imported the parent's main module (torch: seconds), and
  a dataset larger than the pipe's buffer would hold the parent there,
  so the workers would start one after another.
- A task is ``(epoch, idx)``; the dataset seeds each item from
  ``(base_seed, epoch, idx)``, so the samples do not depend on the worker
  count.
- The workers never touch the card: ``CUDA_VISIBLE_DEVICES`` is empty
  for the pool's lifetime (a worker the pool restarts later starts under
  it too) and restored on :meth:`SamplePool.close`. They return numpy.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import tempfile

_WORKER_DATASET = None
_HIDE = "CUDA_VISIBLE_DEVICES"


def _init_worker(path):
    global _WORKER_DATASET
    with open(path, "rb") as f:
        _WORKER_DATASET = pickle.load(f)


def _fetch(task):
    epoch, idx = task
    ds = _WORKER_DATASET
    ds.set_epoch(epoch)
    return ds[idx]


class SamplePool:
    """A process pool mapping dataset indices to prepared samples."""

    def __init__(self, dataset, num_workers: int):
        ctx = mp.get_context("spawn")
        fd, self._path = tempfile.mkstemp(prefix="sample_pool_",
                                          suffix=".pkl")
        self._saved = os.environ.get(_HIDE)
        self._closed = False
        try:
            with os.fdopen(fd, "wb") as f:
                pickle.dump(dataset, f, protocol=pickle.HIGHEST_PROTOCOL)
            os.environ[_HIDE] = ""
            self._pool = ctx.Pool(num_workers, initializer=_init_worker,
                                  initargs=(self._path,))
        except BaseException:
            self._release()
            raise

    def imap(self, epoch: int, indices):
        """The samples of ``indices`` at ``epoch``, in order."""
        return self._pool.imap(_fetch, [(epoch, int(i)) for i in indices],
                               chunksize=1)

    def _release(self):
        if self._saved is None:
            os.environ.pop(_HIDE, None)
        else:
            os.environ[_HIDE] = self._saved
        os.unlink(self._path)
        self._closed = True

    def close(self):
        if self._closed:
            return
        self._pool.terminate()
        self._pool.join()
        self._release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
