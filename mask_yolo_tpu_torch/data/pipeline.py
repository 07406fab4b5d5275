"""Batch generation: dataset → fixed-shape numpy batches — a copy of
`mask_yolo_tpu/data/pipeline.py`: `preload_dataset` and `BatchGenerator`
over a preloaded dataset, the endless `data_generator` (re-read and
re-augmented every epoch) with `GeneratorEpochSource`, and its pooled loader
workers (threads, or fork-started processes). The workers run numpy code
only: a forked loader process inherits the parent's CUDA context and must
never touch it, so nothing in `_load_one` imports or calls torch. The
generators' norm=False debug drawing comes with visualize (ROADMAP Queue 1
#5).

Replaces the reference's BatchGenerator(Sequence)
(reference myolo/myolo_utils.py:689-860). Same contract — indexable,
len() = ceil(N / batch), shuffle between epochs, emits 'yolo'-mode
(image, true_boxes, yolo_target) or 'training'-mode (+ gt_class_ids,
gt_boxes, gt_masks) batches — but the per-instance target encoding is the
vectorized encoder (data/encoder.py) and all outputs are padded to fixed
shapes, the same for every batch.
"""

from __future__ import annotations

import numpy as np

from .encoder import encode_batch
from .loader import load_image_gt, pack_gt


def preload_dataset(dataset, config, image_ids=None, augment=False,
                    augmentation=None, seed=0):
    """Eagerly load + pack every image of a dataset (the reference preloads
    in train(), model.py:993-1006 — but hardcodes 50/6 counts; we load all).

    Returns dict of stacked arrays:
      images [N,H,W,3] uint8 (pipelines normalize on device — 4× less
      host→device transfer than float32), gt_class_ids [N,G],
      gt_boxes [N,G,4], gt_masks [H,W,G] bool (MINI_MASK_SHAPE-sized when
      config.USE_MINI_MASK).
    """
    rng = np.random.RandomState(seed)
    if image_ids is None:
        image_ids = dataset.image_ids
    images, all_ids, all_boxes, all_masks = [], [], [], []
    for image_id in image_ids:
        image, cids, boxes, masks = load_image_gt(
            dataset, config, image_id, augment=augment,
            augmentation=augmentation, rng=rng)
        ids, bxs, msks = pack_gt(cids, boxes, masks, config, rng=rng)
        images.append(np.ascontiguousarray(image, dtype=np.uint8))
        all_ids.append(ids)
        all_boxes.append(bxs)
        all_masks.append(msks)
    return {
        "images": np.stack(images),
        "gt_class_ids": np.stack(all_ids),
        "gt_boxes": np.stack(all_boxes),
        "gt_masks": np.stack(all_masks),
    }


class BatchGenerator:
    """Fixed-shape batch source over a preloaded dataset dict."""

    def __init__(self, data: dict, config, mode: str = "training",
                 shuffle: bool = True, seed: int | None = None):
        if mode not in ("yolo", "training"):
            raise ValueError(f"mode must be 'yolo' or 'training', got {mode!r}")
        self.data = data
        self.config = config
        self.mode = mode
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.n = data["images"].shape[0]
        self.order = np.arange(self.n)
        if shuffle:
            self.rng.shuffle(self.order)

    def __len__(self):
        return int(np.ceil(self.n / self.config.BATCH_SIZE))

    def on_epoch_end(self):
        if self.shuffle:
            self.rng.shuffle(self.order)

    def size(self):
        return self.n

    def num_classes(self):
        return self.config.NUM_CLASSES

    def __getitem__(self, idx):
        bs = self.config.BATCH_SIZE
        lo = idx * bs
        hi = min((idx + 1) * bs, self.n)
        if hi - lo < bs:  # keep batches full & static (reference wraps the
            lo = max(0, hi - bs)  # window back, myolo_utils.py:731-733)
        ids = self.order[lo:hi]
        if ids.shape[0] < bs:  # dataset smaller than a batch: tile
            ids = np.resize(ids, bs)

        images = self.data["images"][ids]
        gt_ids = self.data["gt_class_ids"][ids]
        gt_boxes = self.data["gt_boxes"][ids]
        yolo_target, true_boxes = encode_batch(gt_boxes, gt_ids, self.config)

        batch = {
            "image": images,
            "true_boxes": true_boxes,
            "yolo_target": yolo_target,
        }
        if self.mode == "training":
            batch["gt_class_ids"] = gt_ids
            batch["gt_boxes"] = gt_boxes.astype(np.float32)
            batch["gt_masks"] = self.data["gt_masks"][ids]
        return batch


class GeneratorEpochSource:
    """Adapt the endless `data_generator` to the epoch-indexed source
    run_epoch/DevicePrefetcher expect. Each __getitem__ pulls the next batch,
    so augmentation is re-sampled every epoch (reference semantics —
    fit_generator drew from the generator forever, model.py:1047)."""

    def __init__(self, gen, steps_per_epoch: int, config):
        self.gen = gen
        self.steps = steps_per_epoch
        self.config = config

    def __len__(self):
        return self.steps

    def __getitem__(self, i):
        return next(self.gen)

    def on_epoch_end(self):
        pass


def _load_one(dataset, config, image_id, augment, augmentation, seed):
    """Load + pack one image with a private RandomState(seed) — the unit of
    work for the threaded loader. Augmenter instances are driven statelessly
    through .apply(image, mask, rng) so their internal stream is never
    touched from a worker thread."""
    from .augment import Augmenter
    from .loader import load_image_gt, pack_gt

    r = np.random.RandomState(seed)
    aug = augmentation
    if isinstance(aug, Augmenter):
        base = aug

        def aug(im, m):
            return base.apply(im, m, r)

    image, cids, boxes, masks = load_image_gt(
        dataset, config, image_id, augment=augment, augmentation=aug, rng=r)
    ids, bxs, msks = pack_gt(cids, boxes, masks, config, rng=r)
    return np.ascontiguousarray(image, dtype=np.uint8), ids, bxs, msks


def _assemble(items, config, mode):
    """B loaded items (image, class ids, boxes, masks) as one batch dict."""
    images, gt_ids, gt_boxes, gt_masks = (np.stack([it[i] for it in items]) for i in range(4))
    yolo_target, true_boxes = encode_batch(gt_boxes, gt_ids, config)
    batch = {"image": images, "true_boxes": true_boxes, "yolo_target": yolo_target}
    if mode == "training":
        batch["gt_class_ids"] = gt_ids
        batch["gt_boxes"] = gt_boxes.astype(np.float32)
        batch["gt_masks"] = gt_masks
    return batch


def data_generator(dataset, config, shuffle=True, augment=False,
                   augmentation=None, mode="training", error_limit=5,
                   seed=0, norm=True, workers: int | None = None):
    """Endless python-generator batch source — the reference's legacy
    `data_generator` surface (myolo_utils.py:457-686), including its
    skip-after-logging error policy (errors on one image are logged and the
    image skipped; more than `error_limit` consecutive errors re-raises,
    myolo_utils.py:677-686).

    Yields the same fixed-shape batch dicts as BatchGenerator. Unlike the
    preload path this re-reads (and re-augments) images every epoch, so it
    suits datasets too large to preload or with stochastic augmentation.
    seed drives shuffling, the `augment` flip and GT subsampling;
    norm=False (the debug drawing) raises until visualize is ported.

    workers (default config.DATA_WORKERS): >0 runs per-image load+augment
    on a worker pool (the reference merely computed cpu_count() and left
    multiprocessing disabled, model.py:1045,1057-1058). Each image gets a
    RandomState seeded from the master stream at submission, so output is
    reproducible AND identical for every workers ≥ 1 (it differs from the
    workers=0 stream, which threads one RandomState through sequentially).
    config.DATA_WORKER_MODE picks the pool: "thread" (default; cheap, but
    the Python-level per-image code still serializes on the GIL) or
    "process" (fork-start worker processes — real CPU parallelism; state
    reaches workers by fork inheritance, so locally-defined Config/Dataset
    classes work without being picklable).
    """
    import logging

    from .loader import load_image_gt, pack_gt

    if not norm:
        raise NotImplementedError(
            "norm=False (debug drawing) is not ported yet (ROADMAP Queue 1 #5, item 8: "
            "utils/visualize.py)")
    if workers is None:
        workers = int(getattr(config, "DATA_WORKERS", 0) or 0)
    if workers > 0:
        yield from _data_generator_pooled(
            dataset, config, shuffle, augment, augmentation, mode,
            error_limit, seed, workers,
            pool_mode=str(getattr(config, "DATA_WORKER_MODE", "thread")))
        return

    b = config.BATCH_SIZE
    image_ids = np.copy(dataset.image_ids)
    rng = np.random.RandomState(seed)
    index, errors = -1, 0
    items = []
    while True:
        index = (index + 1) % len(image_ids)
        if shuffle and index == 0:
            rng.shuffle(image_ids)
        image_id = image_ids[index]
        try:
            image, cids, boxes, masks = load_image_gt(
                dataset, config, image_id, augment=augment,
                augmentation=augmentation, rng=rng)
            ids, bxs, msks = pack_gt(cids, boxes, masks, config, rng=rng)
            errors = 0
        except Exception:
            logging.exception("Error processing image %s",
                              dataset.image_info[image_id])
            errors += 1
            if errors > error_limit:
                raise
            continue
        items.append((np.ascontiguousarray(image, dtype=np.uint8), ids, bxs, msks))
        if len(items) < b:
            continue
        yield _assemble(items, config, mode)
        items = []


_FORK_STATE = None  # handoff to fork-started workers (inherited, not pickled)


def _forked_worker_main(tasks, results):
    """Loop of one fork-started loader process: (seq, image_id, seed) in,
    (seq, ("ok", item) | ("err", traceback)) out."""
    dataset, config, augment, augmentation = _FORK_STATE
    while True:
        t = tasks.get()
        if t is None:
            return
        seq, image_id, img_seed = t
        try:
            item = _load_one(dataset, config, image_id, augment, augmentation,
                             img_seed)
            results.put((seq, ("ok", item)))
        except Exception:
            import traceback

            results.put((seq, ("err", traceback.format_exc())))


class _ForkedLoaderPool:
    """Fork-start process pool for per-image loading.

    Real CPU parallelism: the per-image pipeline is mostly Python/numpy
    bytecode that a thread pool serializes on the GIL. State (dataset,
    config, augmenter) reaches the workers by fork inheritance through
    `_FORK_STATE` — nothing is pickled, so locally-defined Config/Dataset
    subclasses work. Workers are daemons; `close()` drains them with a
    terminate fallback. The parent usually holds a CUDA context by the time
    it forks; the children run `_load_one` (numpy and the native image ops)
    and never touch torch, which is what keeps that safe."""

    def __init__(self, dataset, config, augment, augmentation, workers):
        import multiprocessing as mp

        global _FORK_STATE
        ctx = mp.get_context("fork")
        self.tasks = ctx.Queue()
        self.results = ctx.Queue()
        _FORK_STATE = (dataset, config, augment, augmentation)
        try:
            self.procs = [
                ctx.Process(target=_forked_worker_main,
                            args=(self.tasks, self.results), daemon=True)
                for _ in range(workers)]
            for p in self.procs:
                p.start()
        finally:
            _FORK_STATE = None
        self._buf = {}

    def submit(self, seq, image_id, img_seed):
        self.tasks.put((seq, int(image_id), int(img_seed)))

    def result(self, seq, timeout=300.0):
        while seq not in self._buf:
            s, payload = self.results.get(timeout=timeout)
            self._buf[s] = payload
        status, val = self._buf.pop(seq)
        if status == "err":
            raise RuntimeError(f"loader worker failed:\n{val}")
        return val

    def close(self):
        for _ in self.procs:
            try:
                self.tasks.put(None)
            except Exception:
                pass
        for p in self.procs:
            p.join(timeout=1.0)
            if p.is_alive():
                p.terminate()


def _data_generator_pooled(dataset, config, shuffle, augment, augmentation,
                           mode, error_limit, seed, workers,
                           pool_mode="thread"):
    """Worker-pooled body of data_generator(workers>0). Work items are
    submitted in shuffle order with sequentially-derived seeds and consumed
    in submission order, so batches are deterministic in (seed, dataset) and
    independent of the worker count AND of the pool mode (thread/process run
    the identical per-image computation from the identical seeds)."""
    import logging
    from collections import deque

    b = config.BATCH_SIZE
    image_ids = np.copy(dataset.image_ids)
    rng = np.random.RandomState(seed)
    depth = max(2 * workers, b)

    if pool_mode == "process":
        pool = _ForkedLoaderPool(dataset, config, augment, augmentation,
                                 workers)
        seq_counter = [0]

        def do_submit(image_id, img_seed):
            seq = seq_counter[0]
            seq_counter[0] += 1
            pool.submit(seq, image_id, img_seed)
            return seq

        def do_result(handle):
            return pool.result(handle)

        def do_close():
            pool.close()
    elif pool_mode == "thread":
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=workers,
                                  thread_name_prefix="myolo-data")

        def do_submit(image_id, img_seed):
            return pool.submit(_load_one, dataset, config, image_id,
                               augment, augmentation, img_seed)

        def do_result(handle):
            return handle.result()

        def do_close():
            pool.shutdown(wait=False, cancel_futures=True)
    else:
        raise ValueError(f"DATA_WORKER_MODE must be 'thread' or 'process', "
                         f"got {pool_mode!r}")

    try:
        pending: deque = deque()
        index, errors = -1, 0
        items = []

        def submit_next():
            nonlocal index
            index = (index + 1) % len(image_ids)
            if shuffle and index == 0:
                rng.shuffle(image_ids)
            image_id = int(image_ids[index])
            img_seed = int(rng.randint(1 << 31))
            pending.append((image_id, do_submit(image_id, img_seed)))

        while True:
            while len(pending) < depth:
                submit_next()
            image_id, handle = pending.popleft()
            try:
                item = do_result(handle)
                errors = 0
            except Exception:
                logging.exception("Error processing image %s",
                                  dataset.image_info[image_id])
                errors += 1
                if errors > error_limit:
                    raise
                continue
            items.append(item)
            if len(items) < b:
                continue
            yield _assemble(items, config, mode)
            items = []
    finally:
        # reached on generator .close()/GC: don't leak pool workers
        do_close()
