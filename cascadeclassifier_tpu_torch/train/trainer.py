"""Cascade training loop (CvCascadeClassifier).

Counterpart of ``cascadeclassifier_tpu/train/trainer.py::CascadeTrainer``,
with the same stdout transcript. Replicates the reference training loop
(cascadeclassifier.cpp:137-295):

  - per stage: refill the working set with positives still accepted by
    the trained stages and freshly mined hard negatives (prorated), mined
    a whole (image, scale) level at a time on the device — selection-
    equivalent because the negative schedule is deterministic
    (data/negreader.py)
  - stop on: cannot fill / required leaf false-alarm rate reached
    (maxFalseAlarm^numStages / max_depth) / acceptanceRatioBreakValue
  - checkpointing: params.xml after stage 0, stage%d.xml per stage (global
    feature indices); resume via load()
  - final save in the modern cascade.xml format with featureMap compaction
    (cascadeclassifier.cpp:566-578), optional legacy Haar format

Ported: Haar (BASIC, CORE, ALL), LBP and HOG features, DAB, RAB, LB and
GAB weak trees of any depth. ``load`` reads any checkpoint. The trainer
runs on ``device`` ("cuda" unless the caller asks for the CPU); with a
``mesh`` (parallel/sharded.py::FeatureMesh) each stage's split search is
sharded over its features (train/boost.py). On a process mesh every rank
runs the whole trainer, mining included, and returns the same model;
rank 0 alone writes files.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from cascadeclassifier_tpu_torch.data.negreader import NegReader
from cascadeclassifier_tpu_torch.data.vec import PosReader
from cascadeclassifier_tpu_torch.models.model import (
    FEATURE_HAAR,
    FEATURE_HOG,
    FEATURE_LBP,
    CascadeModel,
    HaarFeature,
    HOGFeature,
    LBPFeature,
)
from cascadeclassifier_tpu_torch.models.xml_io import (
    read_params_xml,
    read_stage_xml,
    write_cascade_xml,
    write_legacy_haar_xml,
    write_params_xml,
    write_stage_xml,
)
from cascadeclassifier_tpu_torch.ops.features import HOG_FEAT_SIZE, haar_mode_id
from cascadeclassifier_tpu_torch.train.boost import BoostParams, StageTrainer, check_mesh
from cascadeclassifier_tpu_torch.train.evaluators import make_evaluator
from cascadeclassifier_tpu_torch.train.predictor import CascadePredictor
from cascadeclassifier_tpu_torch.utils.profiling import span, timed


class CascadeTrainer:
    """End-to-end cascade trainer with the traincascade CLI's surface."""

    def __init__(
        self,
        feature_type=FEATURE_HAAR,
        win_w: int = 24,
        win_h: int = 24,
        haar_mode="BASIC",
        boost: BoostParams | None = None,
        mining_batch: int = 131072,
        precalc_val_mb: float = 1024.0,
        precalc_idx_mb: float = 1024.0,
        mesh=None,
        device="cuda",
    ):
        """precalc_val_mb / precalc_idx_mb: precalc buffer budgets — the
        -precalcValBufSize / -precalcIdxBufSize CLI flags (reference
        traincascade.cpp:44-49 defaults 1024 MB each; semantics
        o_cvcascadeboosttraindata.cpp:250-264). device: where features are
        evaluated and samples mined; "cuda" raises without a CUDA device.
        mesh: a FeatureMesh whose shards sort and split the features
        (on a process mesh, ``device`` is the rank's own)."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CascadeTrainer(device='cuda') needs a CUDA device; "
                               "pass device='cpu' to train on the host")
        self.feature_type = feature_type
        self.win_w, self.win_h = win_w, win_h
        self.haar_mode = haar_mode_id(haar_mode) if feature_type == FEATURE_HAAR else 0
        self.boost = boost or BoostParams()
        self.mining_batch = mining_batch
        self.precalc_val_mb = precalc_val_mb
        self.precalc_idx_mb = precalc_idx_mb
        check_mesh(mesh)
        self.mesh = mesh
        self._evaluator = None
        self.stages = []  # stages with GLOBAL feature indices

    @property
    def writes(self) -> bool:
        """Whether this process writes the checkpoints and the cascade:
        rank 0 of a process mesh, always otherwise."""
        return self.mesh is None or self.mesh.rank == 0

    @property
    def max_cat_count(self) -> int:
        return 256 if self.feature_type == FEATURE_LBP else 0

    @property
    def evaluator(self):
        """The training evaluator, built on first use."""
        if self._evaluator is None:
            self._evaluator = make_evaluator(self.feature_type, self.win_w, self.win_h,
                                             self.haar_mode, device=self.device)
        return self._evaluator

    # ------------------------------------------------------------------ io

    def _predictor(self):
        return CascadePredictor(lambda: self.evaluator, self.stages)

    def _fill_positives(self, pos: PosReader, count, consumed_counter):
        """fillPassedSamples for positives (cascadeclassifier.cpp:329-357):
        consume vec samples until `count` pass the current cascade."""
        kept = []
        pred = self._predictor()
        while len(kept) < count:
            batch = pos.take(min(self.mining_batch, count - len(kept)))
            consumed_counter[0] += len(batch)
            ok = pred.predict_batch(batch)
            for i in np.nonzero(ok)[0]:
                kept.append(batch[i])
                if len(kept) >= count:
                    # unconsumed tail of the batch stays consumed, exactly
                    # like the reference's per-sample loop would not — so
                    # rewind the cursor for the unread remainder
                    consumed_counter[0] -= len(batch) - 1 - i
                    pos.unread(len(batch) - 1 - i)
                    break
        return np.stack(kept) if kept else np.zeros(
            (0, self.win_h, self.win_w), np.uint8
        )

    def _fill_negatives(self, neg: NegReader, count, min_acceptance, consumed_counter):
        """fillPassedSamples for negatives with the per-sample acceptance
        check (cascadeclassifier.cpp:334-357).

        Dense device mining: whole (image, scale) schedule levels are
        speculatively enumerated (cheap state snapshots), their window
        grids extracted and predicted ON DEVICE in ~mining_batch-window
        superbatches — one small image upload per level and one result
        fetch per superbatch instead of the reference's per-window crop +
        predict loop. Selection-equivalent: the window schedule is
        deterministic (data/negreader.py) and the accept walk below
        replays the reference's per-window consume/acceptance order,
        rewinding the reader to the exact stop window."""
        kept = []
        pred = self._predictor()
        stop = exhausted = False
        ww, wh = self.win_w, self.win_h
        while len(kept) < count and not stop and not exhausted:
            snaps, lvls = [], []
            total = 0
            with span("mine.gather"):
                while total < self.mining_batch:
                    snaps.append(neg.state())
                    lvl = neg.level_positions()
                    if lvl is None:
                        exhausted = True
                        break
                    img, pos = lvl
                    lvls.append(
                        (img, pos, (neg.last, float(neg.scale)))
                    )
                    total += len(pos)
                    if not neg.skip(len(pos)):
                        exhausted = True
                        break
            if not lvls:
                break
            with span("mine.predict"):
                oks = pred.predict_levels(lvls, ww, wh)
            fini = False
            li_stop = j_stop = 0
            for li, ((img, pos, _key), ok) in enumerate(zip(lvls, oks)):
                # vectorized replay of the reference's per-window
                # consume/acceptance walk (cascadeclassifier.cpp:334-357):
                # the per-window Python loop costs O(consumed) — millions
                # of iterations per stage once acceptance < 1e-4 — while
                # only the (few) accepted windows need Python at all.
                n = len(pos)
                okb = np.asarray(ok[:n], dtype=bool)
                kept_excl = len(kept) + np.concatenate(
                    ([0], np.cumsum(okb[:-1], dtype=np.int64))
                ) if n else np.zeros(0, np.int64)
                consumed_b = consumed_counter[0] + np.arange(
                    n, dtype=np.int64
                )
                with np.errstate(divide="ignore"):
                    ratio_stop = (consumed_b != 0) & (
                        (kept_excl + 1)
                        / np.maximum(consumed_b, 1).astype(np.float64)
                        <= min_acceptance
                    )
                full_stop = okb & (kept_excl + 1 >= count)
                s = int(np.argmax(ratio_stop)) if ratio_stop.any() else n
                f = int(np.argmax(full_stop)) if full_stop.any() else n
                if s <= f and s < n:  # ratio stop BEFORE consuming s
                    upper, j_stop = s, s
                    stop = fini = True
                elif f < n:  # kept reaches count AT window f (consumed)
                    upper, j_stop = f + 1, f + 1
                    fini = True
                else:
                    upper = n
                consumed_counter[0] += upper
                for i in np.nonzero(okb[:upper])[0]:
                    px, py = int(pos[i, 0]), int(pos[i, 1])
                    kept.append(img[py : py + wh, px : px + ww].copy())
                if fini:
                    li_stop = li
                    break
            if fini:
                # rewind the reader to the exact window after the stop
                neg.set_state(snaps[li_stop])
                neg.skip(j_stop)
        return np.stack(kept) if kept else np.zeros(
            (0, self.win_h, self.win_w), np.uint8
        )

    # -------------------------------------------------------------- model

    def _to_model(self, compact=True) -> CascadeModel:
        """Build a CascadeModel; with compact=True remap feature indices to
        the used subset (getUsedFeaturesIdxMap, cascadeclassifier.cpp:566)."""
        m = CascadeModel(
            feature_type=self.feature_type,
            width=self.win_w,
            height=self.win_h,
            stages=[],
            features=[],
            boost_type=self.boost.boost_type,
            min_hit_rate=self.boost.min_hit_rate,
            max_false_alarm=self.boost.max_false_alarm,
            weight_trim_rate=self.boost.weight_trim_rate,
            max_depth=self.boost.max_depth,
            max_weak_count=self.boost.weak_count,
            max_cat_count=self.max_cat_count,
            feat_size=HOG_FEAT_SIZE if self.feature_type == FEATURE_HOG else 1,
            haar_mode={0: "BASIC", 1: "CORE", 2: "ALL"}[self.haar_mode]
            if self.feature_type == FEATURE_HAAR
            else "BASIC",
        )
        import copy

        stages = copy.deepcopy(self.stages)
        if compact:
            used = sorted(
                {
                    int(v)
                    for s in stages
                    for t in s.trees
                    for v in t.feature_idx
                }
            )
            remap = {v: i for i, v in enumerate(used)}
            for s in stages:
                for t in s.trees:
                    t.feature_idx = np.array(
                        [remap[int(v)] for v in t.feature_idx], np.int32
                    )
            m.features = [self._feature_of_var(v) for v in used]
        else:
            m.features = []
        m.stages = stages
        return m

    def _feature_of_var(self, var: int):
        cat = self.evaluator.catalog
        if self.feature_type == FEATURE_LBP:
            return LBPFeature(rect=tuple(int(v) for v in cat.rects[var]))
        if self.feature_type == FEATURE_HOG:
            f, comp = divmod(var, HOG_FEAT_SIZE)
            return HOGFeature(rect=tuple(int(v) for v in cat.rects[f]), component=comp)
        rects = []
        for r in range(3):
            if cat.weights[var, r] == 0.0:
                break
            x, y, w, h = (int(v) for v in cat.rects[var, r])
            rects.append((x, y, w, h, float(cat.weights[var, r])))
        return HaarFeature(rects=rects, tilted=bool(cat.tilted[var]))

    def load(self, data_dir: str) -> bool:
        """Resume from params.xml + stage%d.xml (cascadeclassifier.cpp:534)."""
        params_path = os.path.join(data_dir, "params.xml")
        if not os.path.exists(params_path):
            return False
        pm = read_params_xml(params_path)
        self.feature_type = pm.feature_type
        self.win_w, self.win_h = pm.width, pm.height
        self.haar_mode = (
            haar_mode_id(pm.haar_mode) if pm.feature_type == FEATURE_HAAR else 0
        )
        self.boost = BoostParams(
            boost_type=pm.boost_type,
            min_hit_rate=pm.min_hit_rate,
            max_false_alarm=pm.max_false_alarm,
            weight_trim_rate=pm.weight_trim_rate,
            max_depth=pm.max_depth,
            weak_count=pm.max_weak_count,
        )
        self._evaluator = None
        self.stages = []
        si = 0
        while True:
            sp = os.path.join(data_dir, f"stage{si}.xml")
            if not os.path.exists(sp):
                break
            self.stages.append(read_stage_xml(sp, self.max_cat_count))
            si += 1
        return True

    # -------------------------------------------------------------- train

    def train(
        self,
        data_dir: str,
        vec_path: str,
        bg_path: str,
        num_pos: int,
        num_neg: int,
        num_stages: int = 20,
        acceptance_ratio_break=-1.0,
        base_format_save=False,
        verbose=True,
    ):
        with span("train.job"):
            t_start = time.time()
            with span("train.open"):
                if self.writes:
                    os.makedirs(data_dir, exist_ok=True)
                resumed = self.load(data_dir)
                if resumed and verbose:
                    print("Training parameters are pre-loaded from the parameter "
                          "file in data folder!")
                pos = PosReader(vec_path, self.win_w, self.win_h)
                # lazy: levels materialize on the host only for accepted-window
                # crops; dense mining builds them on the device from the source
                neg = NegReader(bg_path, self.win_w, self.win_h, lazy=True)
            start_stage = len(self.stages)

            p = self.boost
            required_leaf_fa = (
                p.max_false_alarm ** num_stages
            ) / p.max_depth

            for si in range(start_stage, num_stages):
                with span("train.stage"):
                    if verbose:
                        print(f"\n===== TRAINING {si}-stage =====")
                        print("<BEGIN")

                    pos.restart()
                    pos_consumed = [0]
                    with timed("train.fill_positives"):
                        pos_samples = self._fill_positives(pos, num_pos, pos_consumed)
                    if len(pos_samples) == 0:
                        print("Train dataset for temp stage can not be filled. "
                              "Branch training terminated.")
                        break
                    if verbose:
                        print(
                            f"POS count : consumed   {len(pos_samples)} :"
                            f" {pos_consumed[0]}"
                        )

                    pro_num_neg = int(
                        np.rint(num_neg * len(pos_samples) / num_pos)
                    )
                    neg_consumed = [0]
                    with timed("train.fill_negatives"):
                        neg_samples = self._fill_negatives(
                            neg, pro_num_neg, required_leaf_fa, neg_consumed
                        )
                    acceptance = (
                        len(neg_samples) / neg_consumed[0] if neg_consumed[0] else 0.0
                    )
                    if verbose:
                        print(
                            f"NEG count : acceptanceRatio    {len(neg_samples)} :"
                            f" {acceptance:g}"
                        )
                    if len(neg_samples) == 0 and not (
                        neg_consumed[0] > 0
                        and 1.0 / neg_consumed[0] <= required_leaf_fa
                    ):
                        print("Train dataset for temp stage can not be filled. "
                              "Branch training terminated.")
                        break
                    if acceptance <= required_leaf_fa:
                        print("Required leaf false alarm rate achieved. "
                              "Branch training terminated.")
                        break
                    if acceptance_ratio_break >= 0 and acceptance <= acceptance_ratio_break:
                        print("The required acceptanceRatio for the model has been "
                              "reached to avoid overfitting of trainingdata. "
                              "Branch training terminated.")
                        break

                    samples = np.concatenate([pos_samples, neg_samples], axis=0)
                    labels = np.concatenate(
                        [np.ones(len(pos_samples), np.int32),
                         np.zeros(len(neg_samples), np.int32)]
                    )
                    # pad the sample axis to a bucketed size so per-stage sample
                    # counts reuse the same compiled programs
                    n = len(samples)
                    n_pad = max(256, -(-n // 256) * 256)
                    valid = np.zeros(n_pad, bool)
                    valid[:n] = True
                    if n_pad != n:
                        samples = np.concatenate(
                            [samples,
                             np.zeros((n_pad - n, self.win_h, self.win_w), np.uint8)]
                        )
                        labels = np.concatenate(
                            [labels, np.zeros(n_pad - n, np.int32)]
                        )
                    with timed("train.set_samples"):
                        self.evaluator.set_samples(samples)
                    with timed("train.train_stage"):
                        stage, _ = StageTrainer(
                            self.evaluator, p,
                            val_buf_mb=self.precalc_val_mb,
                            idx_buf_mb=self.precalc_idx_mb,
                            mesh=self.mesh,
                        ).train(labels, valid=valid, verbose=verbose)
                    if verbose:
                        print("END>")
                    if stage is None:
                        break
                    self.stages.append(stage)

                    if self.writes:
                        if si == 0:
                            write_params_xml(
                                self._to_model(compact=False),
                                os.path.join(data_dir, "params.xml"),
                                node_name="params",
                            )
                        write_stage_xml(
                            stage,
                            self.max_cat_count > 0,
                            os.path.join(data_dir, f"stage{si}.xml"),
                            node_name=f"stage{si}",
                        )
                    if verbose:
                        dt = int(time.time() - t_start)
                        print(
                            f"Training until now has taken {dt // 86400} days "
                            f"{dt // 3600 % 24} hours {dt // 60 % 60} minutes "
                            f"{dt % 60} seconds."
                        )

            if not self.stages:
                print("Cascade classifier can't be trained. "
                      "Check the used training parameters.")
                return None

            with span("train.save"):
                model = self._to_model(compact=True)
                if not self.writes:
                    return model
                write_cascade_xml(model, os.path.join(data_dir, "cascade.xml"))
                if base_format_save:
                    write_legacy_haar_xml(
                        model, os.path.join(data_dir, "cascade_oldformat.xml")
                    )
                return model
