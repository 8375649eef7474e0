"""Input pipeline: shape-stable batches with background prefetch (port
copy of ``de6d_tpu/datasets/loader.py``, same determinism).

Each sample's augmentation draws from ``RandomState(base_seed + 7919 *
idx)`` with ``base_seed = (seed + epoch * 10007) % 2**31``; the order is
shuffled by ``RandomState(seed + epoch)``; an empty-GT sample re-draws
another index from its own generator; ``drop_last`` only when training;
process ``process_index`` iterates its stride of the index list. The
samples take their turns at the augmentor in the order they were
submitted (the database sampler's ring pointer is shared state), so the
batches do not depend on ``num_workers`` and equal the JAX loader's with
one worker (with more, the JAX loader's samples race for the pointer).

The loader runs in a child process of its own, started by ``spawn`` on
the first iteration or by ``start()`` (a fresh interpreter: forking a process that already
runs CUDA's and PyTorch's threads would copy their held locks). The
dataset is pickled into it as it stands then, and the child keeps it:
the parent's copy is not advanced. The child sends the batches back
through a pipe, so the GIL of the process that dispatches eager PyTorch
ops is not shared with the loader's numpy work (in one process, each op
that drops the GIL waits up to the 5 ms switch interval for a busy
loader thread to hand it back). In the child a thread pool prepares
samples ahead (host-side numpy aug + encode; voxelization happens on the
device) and a prefetch queue hands collated batches over. Every batch is
a fresh set of numpy arrays, never a reused buffer, so a batch may be
copied to the card asynchronously while the next one is built. The
child iterates every epoch it is asked for to its end: a consumer that
stops early leaves the sampler where the whole epoch left it.
"""

from __future__ import annotations

import multiprocessing
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..registry import DATASETS
from .dataset import Turn


def build_dataset(dataset_cfg, class_names, root_path=None, training=True,
                  logger=None):
    cls = DATASETS.get(dataset_cfg["DATASET"])
    return cls(
        dataset_cfg=dataset_cfg,
        class_names=class_names,
        root_path=root_path,
        training=training,
        logger=logger,
    )


class _Turns:
    """Turns at the augmentor in ticket order: ticket k's ``wait()``
    returns once every ticket before it is ``done()``; ``done()`` never
    blocks."""

    def __init__(self):
        self._cond = threading.Condition()
        self._issued = 0  # next ticket to hand out
        self._current = 0  # lowest ticket not yet done
        self._done = set()  # tickets done above _current

    def ticket(self):
        t = self._issued
        self._issued += 1
        return t

    def turn(self, ticket):
        turns = self

        class _T(Turn):
            def wait(self):
                with turns._cond:
                    turns._cond.wait_for(lambda: turns._current == ticket)

            def done(self):
                with turns._cond:
                    if ticket < turns._current or ticket in turns._done:
                        return
                    turns._done.add(ticket)
                    while turns._current in turns._done:
                        turns._done.remove(turns._current)
                        turns._current += 1
                    turns._cond.notify_all()

        return _T()


class DataLoader:
    """Iterable over collated fixed-shape batches."""

    def __init__(self, dataset, batch_size, shuffle, seed=0, drop_last=True,
                 num_workers=4, process_index=0, process_count=1,
                 prefetch=4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = max(num_workers, 1)
        self.process_index = process_index
        self.process_count = process_count
        self.prefetch = prefetch
        self._epoch = 0
        self._turns = None  # the child's (see _serve)
        self._child = None  # (process, requests, batches)
        self._request = 0

    def set_epoch(self, epoch):
        self._epoch = epoch

    def __len__(self):
        n = len(self.dataset) // self.process_count
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _indices(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self._epoch)
            rng.shuffle(order)
        # per-process stride shard (reference DistributedSampler analog)
        return order[self.process_index :: self.process_count]

    def _load_one(self, idx, rng_seed, ticket):
        rng = np.random.RandomState(rng_seed)
        turn = self._turns.turn(ticket)
        try:
            # re-draw on empty-gt samples (reference dataset.py:152-154)
            for attempt in range(8):
                item = self.dataset.getitem_prepared(int(idx), rng,
                                                     turn=turn)
                if item is not None:
                    return item
                idx = rng.randint(len(self.dataset))
            raise RuntimeError("8 consecutive empty samples")
        finally:
            turn.done()

    def start(self):
        """Start the loader's process now, if it is not running (the first
        iteration does otherwise), so that its start overlaps the caller's
        own set-up."""
        if self._child is None:
            ctx = multiprocessing.get_context("spawn")
            requests, batches = ctx.Queue(), ctx.Queue(self.prefetch)
            proc = ctx.Process(target=self._serve, args=(requests, batches),
                               daemon=True)
            proc.start()
            self._child = (proc, requests, batches)

    def __iter__(self):
        self.start()
        proc, requests, batches = self._child
        self._request += 1
        requests.put((self._request, self._epoch))
        while True:
            try:
                tag, batch = batches.get(timeout=60)
            except queue.Empty:
                if not proc.is_alive():
                    raise RuntimeError(
                        f"loader process exited ({proc.exitcode})")
                continue
            if tag != self._request:
                continue  # the rest of an epoch the consumer left early
            if isinstance(batch, BaseException):
                raise batch
            if batch is None:
                return
            yield batch

    def close(self):
        """Stop the loader's process, if it has one (a later iteration
        starts a new one, from this process's state of the dataset)."""
        if self._child is not None:
            proc = self._child[0]
            self._child = None
            proc.terminate()  # it may be blocked on a full queue
            proc.join()

    def _serve(self, requests, batches):
        """The child's loop: each requested epoch's batches, then None
        (or the exception that stopped it), until ``close``."""
        self._turns = _Turns()
        while True:
            tag, epoch = requests.get()
            self._epoch = epoch
            try:
                for batch in self._iter_threads():
                    batches.put((tag, batch))
                batches.put((tag, None))
            except BaseException as e:
                batches.put((tag, e))

    def _iter_threads(self):
        indices = self._indices()
        nb = len(self)
        base_seed = (self.seed + self._epoch * 10007) % (1 << 31)

        def produce(out_q):
            with ThreadPoolExecutor(self.num_workers) as pool:
                futures = []
                for b in range(nb):
                    batch_idx = indices[
                        b * self.batch_size : (b + 1) * self.batch_size
                    ]
                    futs = [
                        pool.submit(self._load_one, i,
                                    base_seed + 7919 * int(i),
                                    self._turns.ticket())
                        for i in batch_idx
                    ]
                    futures.append(futs)
                    # throttle: only keep `prefetch` batches in flight
                    while len(futures) > self.prefetch:
                        done = futures.pop(0)
                        out_q.put(
                            self.dataset.collate_batch(
                                [f.result() for f in done]
                            )
                        )
                for done in futures:
                    out_q.put(
                        self.dataset.collate_batch([f.result() for f in done])
                    )
            out_q.put(None)

        def producer(out_q):
            try:
                produce(out_q)
            except BaseException as e:  # propagate to the consumer
                out_q.put(e)

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        t = threading.Thread(target=producer, args=(q,), daemon=True)
        t.start()
        while True:
            batch = q.get()
            if isinstance(batch, BaseException):
                raise batch  # worker failures must not hang the loop
            if batch is None:
                break
            yield batch


def build_dataloader(dataset_cfg, class_names, batch_size, root_path=None,
                     training=True, seed=0, workers=4, logger=None,
                     process_index=0, process_count=1):
    dataset = build_dataset(
        dataset_cfg, class_names, root_path, training, logger
    )
    loader = DataLoader(
        dataset,
        batch_size=batch_size,
        shuffle=training,
        seed=seed,
        drop_last=training,
        num_workers=workers,
        process_index=process_index,
        process_count=process_count,
    )
    return dataset, loader
