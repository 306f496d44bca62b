"""Evaluators — the port of ``paddle_tpu/fluid/evaluator.py`` (analog of
python/paddle/v2/fluid/evaluator.py): metrics aggregated across
minibatches as persistable state vars that program ops update, so they
run inside the captured training step, plus ``reset`` / ``eval`` on the
host.  ``reset`` puts zeros in the scope in the state's place (on its
device), which the step's next replay copies into the buffers its graph
holds; ``eval`` reads the counts on the host, outside the step."""

from __future__ import annotations

import numpy as np
import torch

from . import layers
from .executor import global_scope, scope_to_numpy
from .framework import Variable
from .initializer import ConstantInitializer
from .layer_helper import LayerHelper

__all__ = ["Evaluator", "Accuracy", "ChunkEvaluator", "AUC",
           "DetectionMAP"]


def _host(scope, name) -> np.ndarray:
    """A state var of ``scope`` as a numpy array (copied off the card)."""
    return np.asarray(scope_to_numpy(scope, [name])[name])


class Evaluator:
    """Base: tracks persistable state vars; reset() zeroes them in the scope
    (the reference re-runs fill ops; writing the scope directly is the same
    contract without a program run)."""

    def __init__(self, name: str, **kwargs):
        self.helper = LayerHelper(name, **kwargs)
        self.states = []
        self.metrics = []

    def _create_state(self, suffix: str, dtype: str, shape):
        var = self.helper.create_global_variable(
            shape=shape, dtype=dtype, persistable=True,
            name=f"{self.helper.name}.{suffix}")
        self.helper.set_variable_initializer(var, ConstantInitializer(0.0))
        self.states.append(var)
        return var

    def reset(self, executor=None, reset_program=None, scope=None):
        scope = scope or global_scope()
        for s in self.states:
            cur = scope.find_var(s.name)
            if cur is not None:
                scope.set_var(s.name, torch.zeros_like(cur)
                              if isinstance(cur, torch.Tensor)
                              else np.zeros_like(np.asarray(cur)))

    def eval(self, executor=None, eval_program=None, scope=None):
        raise NotImplementedError


class Accuracy(Evaluator):
    """Streaming accuracy over batches (reference evaluator.py Accuracy)."""

    def __init__(self, input, label, k=1, **kwargs):
        super().__init__("accuracy", **kwargs)
        self.total = self._create_state("total", "float32", [1])
        self.correct = self._create_state("correct", "float32", [1])
        correct = self.helper.create_tmp_variable("int32",
                                                  stop_gradient=True)
        total = self.helper.create_tmp_variable("int32", stop_gradient=True)
        acc = layers.accuracy(input=input, label=label, k=k,
                              correct=correct, total=total)
        # accumulate into the persistable state inside the step
        self.helper.append_op(
            "elementwise_add",
            {"X": self.total, "Y": _as_float(self.helper, total)},
            {"Out": self.total})
        self.helper.append_op(
            "elementwise_add",
            {"X": self.correct, "Y": _as_float(self.helper, correct)},
            {"Out": self.correct})
        self.metrics.append(acc)

    def eval(self, executor=None, eval_program=None, scope=None):
        scope = scope or global_scope()
        total = float(_host(scope, self.total.name).sum())
        correct = float(_host(scope, self.correct.name).sum())
        return np.array(correct / max(total, 1.0), np.float32)


class ChunkEvaluator(Evaluator):
    """Streaming chunk F1 (reference evaluator.py ChunkEvaluator, backed by
    chunk_eval_op.cc).  Consumes the chunk_eval op's per-batch counts."""

    def __init__(self, input, label, chunk_scheme, num_chunk_types,
                 excluded_chunk_types=None, **kwargs):
        super().__init__("chunk", **kwargs)
        self.num_infer = self._create_state("num_infer", "float32", [1])
        self.num_label = self._create_state("num_label", "float32", [1])
        self.num_correct = self._create_state("num_correct", "float32", [1])
        precision = self.helper.create_tmp_variable("float32",
                                                    stop_gradient=True)
        recall = self.helper.create_tmp_variable("float32",
                                                 stop_gradient=True)
        f1 = self.helper.create_tmp_variable("float32", stop_gradient=True)
        ni = self.helper.create_tmp_variable("float32", stop_gradient=True)
        nl = self.helper.create_tmp_variable("float32", stop_gradient=True)
        nc = self.helper.create_tmp_variable("float32", stop_gradient=True)
        self.helper.append_op(
            "chunk_eval", {"Inference": input, "Label": label},
            {"Precision": precision, "Recall": recall, "F1-Score": f1,
             "NumInferChunks": ni, "NumLabelChunks": nl,
             "NumCorrectChunks": nc},
            {"chunk_scheme": chunk_scheme,
             "num_chunk_types": num_chunk_types,
             "excluded_chunk_types": excluded_chunk_types or []})
        for state, cur in [(self.num_infer, ni), (self.num_label, nl),
                           (self.num_correct, nc)]:
            self.helper.append_op("elementwise_add",
                                  {"X": state, "Y": cur}, {"Out": state})
        self.metrics += [precision, recall, f1]

    def eval(self, executor=None, eval_program=None, scope=None):
        scope = scope or global_scope()
        ni = float(_host(scope, self.num_infer.name).sum())
        nl = float(_host(scope, self.num_label.name).sum())
        nc = float(_host(scope, self.num_correct.name).sum())
        p = nc / max(ni, 1e-6)
        r = nc / max(nl, 1e-6)
        f1 = 2 * p * r / max(p + r, 1e-6)
        return np.array([p, r, f1], np.float32)


def _as_float(helper, int_var):
    out = helper.create_tmp_variable("float32", stop_gradient=True)
    helper.append_op("cast", {"X": int_var}, {"Out": out},
                     {"out_dtype": "float32"})
    return out


class AUC(Evaluator):
    """Streaming ROC-AUC (the evaluator OBJECT the reference carried in
    gserver/evaluators/Evaluator.cpp AucEvaluator; the per-batch `auc`
    op existed here since r2 but no cross-batch aggregation did).

    Positive-class scores are histogrammed into ``num_thresholds`` bins
    per batch INSIDE the step (one_hot of the bin index, masked by the
    label, reduced) and accumulated into persistable state; ``eval()``
    integrates the trapezoid ROC on the host from the two histograms —
    the same two-histogram scheme the reference used, expressed as graph
    ops instead of a CUDA kernel."""

    def __init__(self, input, label, num_thresholds=200, **kwargs):
        super().__init__("auc_eval", **kwargs)
        t = int(num_thresholds)
        self.num_thresholds = t
        self.stat_pos = self._create_state("stat_pos", "float32", [t])
        self.stat_neg = self._create_state("stat_neg", "float32", [t])
        h = self.helper
        # positive-class probability -> bin in [0, t)
        pos = layers.split(input, num_or_sections=input.shape[-1],
                           dim=-1)[-1]
        # clamp to [0, t-1] BEFORE the cast: out-of-[0,1] scores (logits
        # passed directly) must land in the edge bins, not vanish as
        # all-zero one_hot rows (the reference auc op clamps the same way)
        binf = layers.clip(layers.scale(pos, scale=float(t - 1)),
                           min=0.0, max=float(t - 1))
        bini = h.create_tmp_variable("int32", stop_gradient=True)
        h.append_op("cast", {"X": binf}, {"Out": bini},
                    {"out_dtype": "int32"})
        onehot = layers.one_hot(bini, depth=t)          # [N, t]
        labf = _as_float(h, label)
        is_pos = layers.reshape(labf, [-1, 1])
        pos_hist = layers.reduce_sum(
            layers.elementwise_mul(onehot, is_pos), dim=0)
        neg_hist = layers.reduce_sum(
            layers.elementwise_mul(
                onehot, layers.scale(is_pos, scale=-1.0, bias=1.0)), dim=0)
        h.append_op("elementwise_add",
                    {"X": self.stat_pos, "Y": pos_hist},
                    {"Out": self.stat_pos})
        h.append_op("elementwise_add",
                    {"X": self.stat_neg, "Y": neg_hist},
                    {"Out": self.stat_neg})

    def eval(self, executor=None, eval_program=None, scope=None):
        scope = scope or global_scope()
        pos = _host(scope, self.stat_pos.name).astype(np.float64)
        neg = _host(scope, self.stat_neg.name).astype(np.float64)
        # sweep thresholds from high to low: cumulative TP/FP counts
        tp = np.cumsum(pos[::-1])
        fp = np.cumsum(neg[::-1])
        tot_p, tot_n = max(tp[-1], 1e-9), max(fp[-1], 1e-9)
        tpr = np.concatenate([[0.0], tp / tot_p])
        fpr = np.concatenate([[0.0], fp / tot_n])
        trapezoid = getattr(np, "trapezoid", None) or np.trapz
        return np.array(trapezoid(tpr, fpr), np.float32)


class DetectionMAP:
    """VOC-style detection mean-average-precision (the reference
    gserver/evaluators had a mAP evaluator object; the matching ops
    (bipartite_match, multiclass_nms) exist here, and this aggregates
    their HOST-side outputs — detection mAP is inherently ragged, so
    accumulation happens outside the compiled step, like the
    reference's CPU evaluator did).

    Per batch, call ``update(detections, ground_truths)`` with
      detections:  [[class_id, score, x1, y1, x2, y2], ...] per image
      ground_truths: [[class_id, x1, y1, x2, y2], ...] per image
    ``eval()`` returns mAP over classes at ``overlap_threshold`` IoU
    using the 11-point or area interpolation (``ap_version``)."""

    def __init__(self, overlap_threshold=0.5, ap_version="integral"):
        assert ap_version in ("integral", "11point")
        self.overlap_threshold = float(overlap_threshold)
        self.ap_version = ap_version
        self.reset()

    def reset(self, *a, **kw):
        self._dets = []     # (img_idx, cls, score, box)
        self._gts = []      # (img_idx, cls, box)
        self._img = 0

    @staticmethod
    def _iou(a, b):
        ix1, iy1 = max(a[0], b[0]), max(a[1], b[1])
        ix2, iy2 = min(a[2], b[2]), min(a[3], b[3])
        iw, ih = max(0.0, ix2 - ix1), max(0.0, iy2 - iy1)
        inter = iw * ih
        ua = ((a[2] - a[0]) * (a[3] - a[1]) +
              (b[2] - b[0]) * (b[3] - b[1]) - inter)
        return inter / ua if ua > 0 else 0.0

    def update(self, detections, ground_truths):
        for dets, gts in zip(detections, ground_truths):
            for d in dets:
                self._dets.append((self._img, int(d[0]), float(d[1]),
                                   [float(v) for v in d[2:6]]))
            for g in gts:
                self._gts.append((self._img, int(g[0]),
                                  [float(v) for v in g[1:5]]))
            self._img += 1

    def _ap(self, rec, prec):
        if self.ap_version == "11point":
            return float(np.mean([max([p for r, p in zip(rec, prec)
                                       if r >= th], default=0.0)
                                  for th in np.linspace(0, 1, 11)]))
        # area under the monotone precision envelope
        mrec = np.concatenate([[0.0], rec, [1.0]])
        mpre = np.concatenate([[0.0], prec, [0.0]])
        for i in range(len(mpre) - 2, -1, -1):
            mpre[i] = max(mpre[i], mpre[i + 1])
        idx = np.where(mrec[1:] != mrec[:-1])[0]
        return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))

    def eval(self, *a, **kw):
        classes = sorted({c for _, c, _ in self._gts})
        aps = []
        for cls in classes:
            gts = [(i, box) for i, c, box in self._gts if c == cls]
            npos = len(gts)
            taken = set()
            dets = sorted((d for d in self._dets if d[1] == cls),
                          key=lambda d: -d[2])
            tp = np.zeros(len(dets))
            fp = np.zeros(len(dets))
            for k, (img, _, _, box) in enumerate(dets):
                best, best_j = 0.0, -1
                for j, (gi, gbox) in enumerate(gts):
                    if gi != img or j in taken:
                        continue
                    ov = self._iou(box, gbox)
                    if ov > best:
                        best, best_j = ov, j
                if best >= self.overlap_threshold and best_j >= 0:
                    tp[k] = 1
                    taken.add(best_j)
                else:
                    fp[k] = 1
            if npos == 0:
                continue
            ctp, cfp = np.cumsum(tp), np.cumsum(fp)
            rec = ctp / npos
            prec = ctp / np.maximum(ctp + cfp, 1e-9)
            aps.append(self._ap(rec, prec))
        return np.array(np.mean(aps) if aps else 0.0, np.float32)
