"""The report accumulators and the eval preprocess: the numpy and cv2 side of
the JAX package's eval/reports.py, kept as the port's own copy (the model
side is eval/reports.py of the port).

  Results2Class  2-foreground-class cell counting: per-class contour
                 counting, immune/cell ratio, GAME(1-3), sigma-matched
                 P/R/F1 grid, Pearson r; emits resultsData.csv,
                 resultsGridCount.csv, resultsMatching.csv, results.csv,
                 resultsC.csv, GT-vs-pred scatters, per-image 3-panel visuals
  Results3Class  3-class variant with 5px-centroid detection matching
  RegressionResults  density-map eval: ReLU/200 -> sum = count,
                 peak_local_max localisation, GAME, ratio metrics
  ResultsCC      binary connected-component counting and matching
  TwoChannelRegResults  the two-channel density-regression suite

matplotlib is imported only where a plot is drawn (`_plt`), so the module
loads where it is not installed.
"""

from __future__ import annotations

import os

import numpy as np

from unet_torch_tpu_torch.data.io import (
    to_model_input,
    z_normalize,
    zoom_resize,
)
from unet_torch_tpu_torch.eval.matching import (
    calculate_estimated_coordinates,
    count_accuracy_metric,
    crowd_matching_test,
    gmae,
)


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def noise_filtering(img: np.ndarray, thresh: int = 150) -> np.ndarray:
    """Drop connected components smaller than `thresh` px per class
    (ref test.py:27-40, via cv2 instead of skimage.measure.label)."""
    import cv2

    for cls in np.unique(img):
        if cls == 0:
            continue
        binary = (img == cls).astype(np.uint8)
        n, labels = cv2.connectedComponents(binary, connectivity=8)
        for lbl in range(1, n):
            if (labels == lbl).sum() < thresh:
                img[labels == lbl] = 0
    return img


def preprocess_eval(img_org: np.ndarray, input_size) -> np.ndarray:
    """test_mc3serousv5.py:100-127 — zoom + z-norm + batch dim, NHWC."""
    img = zoom_resize(np.asarray(img_org), input_size[0], input_size[1],
                      order=3)
    img = z_normalize(img.astype(np.float64))
    return to_model_input(img)[None]



# ---------------------------------------------------------------------------
# Results2Class
# ---------------------------------------------------------------------------

class Results2Class:
    def __init__(self, save_dir, save_image=True):
        self.classDict = {1: "other", 2: "immune"}
        self.cellCounts = {k: [] for k in
                           ("GT", "Pred", "AbsDiff", "Accuracy",
                            "AccuracyRelative", "AccuracyRelativePD")}
        self.immuneCounts = {k: [] for k in self.cellCounts}
        self.ratio = {k: [] for k in self.cellCounts}
        self.imageNames = []
        self.G1metrics, self.G2metrics, self.G3metrics = [], [], []
        self.label_colors = [(0, 0, 255), (0, 255, 0), (255, 0, 0)]
        self.save_dir = save_dir
        self.sigma_list = [10, 20]
        self.sigma_thresh_list = list(np.arange(0.5, 1, 0.05))
        S, T = len(self.sigma_list), len(self.sigma_thresh_list)
        self.arr_prec_immune = np.zeros((S, T))
        self.arr_recall_immune = np.zeros((S, T))
        self.arr_f1_immune = np.zeros((S, T))
        self.arr_prec_other = np.zeros((S, T))
        self.arr_recall_other = np.zeros((S, T))
        self.arr_f1_other = np.zeros((S, T))
        self.save_image = save_image
        self.performace_results = {}

    def _find_objects(self, img):
        import cv2

        objectDict, counts = {}, {}
        for cls in self.classDict:
            mask = (img == cls).astype(np.uint8)
            contours, _ = cv2.findContours(mask, cv2.RETR_EXTERNAL,
                                           cv2.CHAIN_APPROX_SIMPLE)
            counts[cls] = len(contours)
            xs, ys = [], []
            for contour in contours:
                m = cv2.moments(contour)
                if m["m00"] == 0:
                    continue
                xs.append(round(m["m10"] / m["m00"]))
                ys.append(round(m["m01"] / m["m00"]))
            objectDict[cls] = (np.array(xs), np.array(ys))
        return objectDict, counts[1], counts[2]

    def _create_rgb_mask(self, mask):
        rgb = np.zeros((mask.shape[0], mask.shape[1], 3), np.uint8)
        for i, color in enumerate(self.label_colors, start=1):
            rgb[mask == i] = color
        return rgb

    def _save_visuals(self, img_org, mask_img, prediction, counts_gt,
                      counts_pred):
        plt = _plt()
        fig, axs = plt.subplots(1, 3)
        fig.set_figheight(12)
        fig.set_figwidth(30)
        if img_org.ndim == 3:
            axs[0].imshow(img_org[..., ::-1])
        else:
            axs[0].imshow(img_org, cmap="gray")
        axs[0].title.set_text("image")
        axs[1].imshow(self._create_rgb_mask(mask_img))
        axs[1].title.set_text("label")
        fig.text(.51, .17, f"tumor: {counts_gt[0]}", ha="center", color="red")
        fig.text(.51, .15, f"immune {counts_gt[1]}", ha="center",
                 color="green")
        axs[2].imshow(self._create_rgb_mask(prediction))
        axs[2].title.set_text("prediction")
        fig.text(.79, .17, f"tumor: {counts_pred[0]}", ha="center",
                 color="red")
        fig.text(.79, .15, f"immune {counts_pred[1]}", ha="center",
                 color="green")
        fig.savefig(os.path.join(self.save_dir, self.imageNames[-1]))
        plt.close(fig)

    def compare_images(self, img_org, gt_img, pred_img, gt_dot):
        gt_dot_other = (gt_dot == 1).astype(np.float64)
        gt_dot_immune = (gt_dot == 2).astype(np.float64)
        cellCountGt = int(np.sum(gt_dot_other))
        immuneCountGt = int(np.sum(gt_dot_immune))

        predDict, cellCountPred, immuneCountPred = self._find_objects(pred_img)

        for store, gt, pred in (
                (self.cellCounts, cellCountGt, cellCountPred),
                (self.immuneCounts, immuneCountGt, immuneCountPred)):
            abs_diff, acc, rel, rpd = count_accuracy_metric(gt, pred)
            store["GT"].append(gt)
            store["Pred"].append(pred)
            store["AbsDiff"].append(abs_diff)
            store["Accuracy"].append(acc)
            store["AccuracyRelative"].append(rel)
            store["AccuracyRelativePD"].append(rpd)

        ratioGT = immuneCountGt / max(cellCountGt + immuneCountGt, 1e-6)
        ratioPred = immuneCountPred / max(cellCountPred + immuneCountPred,
                                          1e-6)
        abs_diff, acc, rel, rpd = count_accuracy_metric(ratioGT, ratioPred)
        self.ratio["GT"].append(ratioGT)
        self.ratio["Pred"].append(ratioPred)
        self.ratio["AbsDiff"].append(round(abs_diff, 4))
        self.ratio["Accuracy"].append(acc)
        self.ratio["AccuracyRelative"].append(rel)
        self.ratio["AccuracyRelativePD"].append(rpd)

        def dot_map(coords, like):
            m = np.zeros_like(like)
            xs, ys = coords
            for x, y in zip(xs, ys):
                m[y, x] = 1
            return m

        e_dot_other = dot_map(predDict[1], gt_dot_other)
        e_dot_immune = dot_map(predDict[2], gt_dot_immune)
        size = gt_dot.shape[0]
        for L, store in ((1, self.G1metrics), (2, self.G2metrics),
                         (3, self.G3metrics)):
            store.append(gmae(L, gt_dot_other, e_dot_other, size)
                         + gmae(L, gt_dot_immune, e_dot_immune, size))

        p, r, f = crowd_matching_test(gt_dot_immune, predDict[2],
                                      self.sigma_list, self.sigma_thresh_list,
                                      input_type="Coordinates")
        self.arr_prec_immune += p
        self.arr_recall_immune += r
        self.arr_f1_immune += f
        p, r, f = crowd_matching_test(gt_dot_other, predDict[1],
                                      self.sigma_list, self.sigma_thresh_list,
                                      input_type="Coordinates")
        self.arr_prec_other += p
        self.arr_recall_other += r
        self.arr_f1_other += f

        if self.save_image:
            self._save_visuals(img_org, gt_img, pred_img,
                               (cellCountGt, immuneCountGt),
                               (cellCountPred, immuneCountPred))

    # reference method name
    compareImages = compare_images

    def save(self):
        import pandas as pd
        from scipy.stats import pearsonr

        performace_results = {
            "sample name": self.imageNames,
            "cell count Gold": self.cellCounts["GT"],
            "cell count Pred": self.cellCounts["Pred"],
            "cell abs diff": self.cellCounts["AbsDiff"],
            "cell accuracy": self.cellCounts["Accuracy"],
            "cell accuracy RD": self.cellCounts["AccuracyRelative"],
            "cell accuracy RD Perantage": self.cellCounts["AccuracyRelativePD"],
            "immune count Gold": self.immuneCounts["GT"],
            "immune count Pred": self.immuneCounts["Pred"],
            "immune abs diff": self.immuneCounts["AbsDiff"],
            "immune accuracy": self.immuneCounts["Accuracy"],
            "immune accuracy RD": self.immuneCounts["AccuracyRelative"],
            "immune accuracy RD Perantage":
                self.immuneCounts["AccuracyRelativePD"],
            "ratio Gold": self.ratio["GT"],
            "ratio Pred": self.ratio["Pred"],
            "ratio abs diff": self.ratio["AbsDiff"],
            "ratio accuracy": self.ratio["Accuracy"],
            "ratio accuracy RD": self.ratio["AccuracyRelative"],
            "ratio accuracy RD Perantage": self.ratio["AccuracyRelativePD"],
        }
        pd.DataFrame(performace_results).to_csv(
            os.path.join(self.save_dir, "resultsData.csv"), index=False)

        columns = ["gmae_cell", "gmae_cellAccuracyRelative",
                   "gmae_cellAccuracyRelativePD", "gmae_immune",
                   "gmae_immuneAccuracyRelative",
                   "gmae_immuneAccuracyRelativePD"]
        means = [pd.DataFrame(g, columns=columns).mean().to_numpy()
                 for g in (self.G1metrics, self.G2metrics, self.G3metrics)]
        pd.DataFrame(means, columns=columns,
                     index=["G(1)", "G(2)", "G(3)"]).to_csv(
            os.path.join(self.save_dir, "resultsGridCount.csv"), index=True)

        n = max(len(self.imageNames), 1)
        for arr in (self.arr_f1_immune, self.arr_prec_immune,
                    self.arr_recall_immune, self.arr_f1_other,
                    self.arr_prec_other, self.arr_recall_other):
            arr /= n

        columns = ["prec_cell", "recall_cell", "f1_cell", "prec_immune",
                   "recall_immune", "f1_immune"]
        index = ["sigma(5)", "sigma(20)", "sigma(5)_09", "sigma(20)_09"]

        def sig_rows(sl):
            pi = np.mean(self.arr_prec_immune[:, sl], axis=1)
            ri = np.mean(self.arr_recall_immune[:, sl], axis=1)
            fi = np.mean(self.arr_f1_immune[:, sl], axis=1)
            po = np.mean(self.arr_prec_other[:, sl], axis=1)
            ro = np.mean(self.arr_recall_other[:, sl], axis=1)
            fo = np.mean(self.arr_f1_other[:, sl], axis=1)
            return ([po[0], ro[0], fo[0], pi[0], ri[0], fi[0]],
                    [po[1], ro[1], fo[1], pi[1], ri[1], fi[1]])

        row1, row2 = sig_rows(slice(None))
        row3, row4 = sig_rows(slice(None, -1))
        pd.DataFrame([row1, row2, row3, row4], columns=columns,
                     index=index).to_csv(
            os.path.join(self.save_dir, "resultsMatching.csv"), index=True)

        plt = _plt()
        for gt_list, pred_list, name, lims in (
                (self.immuneCounts["GT"], self.immuneCounts["Pred"],
                 "resultsData_immune.png", None),
                (self.immuneCounts["GT"], self.immuneCounts["Pred"],
                 "resultsData_immune_200.png", 200),
                (self.immuneCounts["GT"], self.immuneCounts["Pred"],
                 "resultsData_immune_50.png", 50),
                (self.cellCounts["GT"], self.cellCounts["Pred"],
                 "resultsData_other.png", None)):
            plt.scatter(gt_list, pred_list, c="black")
            plt.xlabel("golds")
            plt.ylabel("predictions")
            max_limit = int(max(max(gt_list, default=0),
                                max(pred_list, default=0))) + 100
            lim = lims or max_limit
            plt.xlim(0, lim)
            plt.ylim(0, lim)
            plt.plot(range(max_limit))
            plt.savefig(os.path.join(self.save_dir, name))
            plt.cla()
        plt.close("all")

        def _pearson(a, b):
            if len(a) < 2 or np.std(a) == 0 or np.std(b) == 0:
                return 0.0
            return pearsonr(a, b)[0]

        pearson_cell = _pearson(self.cellCounts["GT"], self.cellCounts["Pred"])
        pearson_immune = _pearson(self.immuneCounts["GT"],
                                  self.immuneCounts["Pred"])
        pearson_ratio = _pearson(self.ratio["GT"], self.ratio["Pred"])

        def mean(v):
            return round(sum(v) / max(len(v), 1), 4)

        filt_cell = [min(x, 5) for x in self.cellCounts["Accuracy"]]
        filt_imm = [min(x, 5) for x in self.immuneCounts["Accuracy"]]
        self.performace_results = {
            "Cell MAE": mean(self.cellCounts["AbsDiff"]),
            "Cell MRE": mean(filt_cell),
            "Cell MRE max": mean(self.cellCounts["AccuracyRelative"]),
            "Cell RPD": mean(self.cellCounts["AccuracyRelativePD"]),
            "Cell Pearson r": pearson_cell,
            "Immune MAE": mean(self.immuneCounts["AbsDiff"]),
            "Immune MRE": mean(filt_imm),
            "Immune MRE max": mean(self.immuneCounts["AccuracyRelative"]),
            "Immune RPD": mean(self.immuneCounts["AccuracyRelativePD"]),
            "Immune Pearson r": pearson_immune,
            "Ratio MAE": mean(self.ratio["AbsDiff"]),
            "Ratio MRE": mean(self.ratio["Accuracy"]),
            "Ratio MRE max": mean(self.ratio["AccuracyRelative"]),
            "Ratio RPD": mean(self.ratio["AccuracyRelativePD"]),
            "Ratio pearson r": pearson_ratio,
        }
        # The reference writes the same values twice with two column spellings:
        # results.csv names the ratio tail columns 'Ratio Accuracy MRE max' /
        # 'Ratio Accuracy RPD' (ref test_mc3serousv5.py:736-737) while
        # resultsC.csv uses 'Ratio MRE max' / 'Ratio RPD' (:752-753).
        first_write = dict(self.performace_results)
        first_write["Ratio Accuracy MRE max"] = first_write.pop(
            "Ratio MRE max")
        first_write["Ratio Accuracy RPD"] = first_write.pop("Ratio RPD")
        first_write["Ratio pearson r"] = first_write.pop("Ratio pearson r")
        pd.DataFrame(first_write, index=[0]).to_csv(
            os.path.join(self.save_dir, "results.csv"), index=False)
        pd.DataFrame(self.performace_results, index=[0]).to_csv(
            os.path.join(self.save_dir, "resultsC.csv"), index=False)

    def get_results(self):
        return self.performace_results

    getResults = get_results


# ---------------------------------------------------------------------------
# Results3Class
# ---------------------------------------------------------------------------

class Results3Class:
    """3-class centroid-matching accumulator (ref test_mc3serousv5.py:131-371);
    the reference's never-initialised `edList` (its :269 latent bug) is fixed."""

    def __init__(self, save_dir, iou_thresh=0.5, save_image=True):
        self.smoothening_factor = 1e-6
        self.classDict = {1: "other", 2: "immune", 3: "tumor"}
        self.cellCounts = {"GT": [], "Pred": [], "Accuracy": []}
        self.immuneCounts = {"GT": [], "Pred": [], "Accuracy": []}
        self.tumorCounts = {"GT": [], "Pred": [], "Accuracy": []}
        self.ratio = {"GTImmo": [], "PredImmo": [], "GTImmoTummor": [],
                      "PredImmoTummor": [], "AccuracyImmoTummor": [],
                      "AccuracyImmo": []}
        self.classRes = {i: {"tp": 0, "fp": 0, "fn": 0, "tn": 0}
                         for i in self.classDict}
        self.tp = self.fp = self.fn = 0
        self.precision, self.recall, self.f1 = [], [], []
        self.edList = []
        self.imageNames = []
        self.label_colors = [(0, 0, 255), (0, 255, 0), (255, 0, 0)]
        self.save_dir = save_dir
        self.save_image = save_image
        self.performace_results = {}

    def _find_objects(self, img):
        import cv2

        objectDict = {}
        counts = {cls: 0 for cls in self.classDict}
        offset = 0
        for cls in np.unique(img):
            if cls == 0 or cls not in counts:
                continue
            mask = (img == cls).astype(np.uint8)
            contours, _ = cv2.findContours(mask, cv2.RETR_EXTERNAL,
                                           cv2.CHAIN_APPROX_SIMPLE)
            counts[cls] = len(contours)
            for i, contour in enumerate(contours):
                objectDict[i + offset] = {"contour": contour, "class": cls}
            offset += len(contours)
        return objectDict, counts[1], counts[2], counts[3]

    def compare_images(self, img_org, gt_img, pred_img):
        import cv2
        from scipy.spatial import distance

        gtDict, cGT, iGT, tGT = self._find_objects(gt_img)
        predDict, cP, iP, tP = self._find_objects(pred_img)
        sf = self.smoothening_factor

        for store, gt, pred in ((self.cellCounts, cGT, cP),
                                (self.immuneCounts, iGT, iP),
                                (self.tumorCounts, tGT, tP)):
            store["GT"].append(gt)
            store["Pred"].append(pred)
            store["Accuracy"].append(round(abs(gt - pred) / (gt + sf), 4))

        ratioImmoGT = iGT / (iGT + tGT + cGT + sf)
        ratioImmoPred = iP / (iP + tP + cP + sf)
        self.ratio["GTImmo"].append(ratioImmoGT)
        self.ratio["PredImmo"].append(ratioImmoPred)
        self.ratio["AccuracyImmo"].append(
            round(abs(ratioImmoGT - ratioImmoPred), 4))
        ratioITGT = iGT / (iGT + tGT + sf)
        ratioITPred = iP / (iP + tP + sf)
        self.ratio["GTImmoTummor"].append(ratioITGT)
        self.ratio["PredImmoTummor"].append(ratioITPred)
        self.ratio["AccuracyImmoTummor"].append(
            round(abs(ratioITGT - ratioITPred), 4))

        tp = 0
        current = {i: {"tp": 0, "TotalGT": 0, "TotalPred": 0}
                   for i in self.classDict}
        pred_centers = {
            k: cv2.minEnclosingCircle(v["contour"])[0]
            for k, v in predDict.items()}
        matched_pred = set()
        for gt in gtDict:
            (xg, yg), _ = cv2.minEnclosingCircle(gtDict[gt]["contour"])
            current[gtDict[gt]["class"]]["TotalGT"] += 1
            for pred, (xp, yp) in pred_centers.items():
                if pred in matched_pred:
                    continue
                ed = distance.euclidean((xg, yg), (xp, yp))
                if ed < 5 and predDict[pred]["class"] == gtDict[gt]["class"]:
                    tp += 1
                    current[predDict[pred]["class"]]["tp"] += 1
                    self.edList.append(ed)
                    matched_pred.add(pred)
                    break
        fp = len(predDict) - tp
        fn = len(gtDict) - tp
        self.tp += tp
        self.fp += fp
        self.fn += fn
        for pred in predDict:
            current[predDict[pred]["class"]]["TotalPred"] += 1
        for i in self.classDict:
            self.classRes[i]["tp"] += current[i]["tp"]
            self.classRes[i]["fp"] += current[i]["TotalPred"] - current[i]["tp"]
            self.classRes[i]["fn"] += current[i]["TotalGT"] - current[i]["tp"]
        n_gt = max(len(gtDict), 1)
        self.recall.append(round(tp / n_gt, 4))
        self.precision.append(round(tp / max(tp + fp, 1), 4))
        self.f1.append(round(tp / max(tp + 0.5 * (fp + fn), 1e-9), 4))

    compareImages = compare_images

    def save(self):
        import pandas as pd

        performace_results = {
            "sample name": self.imageNames,
            "precision": self.precision,
            "recall": self.recall,
            "f1": self.f1,
            "cell count Gold": self.cellCounts["GT"],
            "cell count Pred": self.cellCounts["Pred"],
            "cell count accuracy": self.cellCounts["Accuracy"],
            "immune count Gold": self.immuneCounts["GT"],
            "immune count Pred": self.immuneCounts["Pred"],
            "immune accuracy": self.immuneCounts["Accuracy"],
            "tumor count Gold": self.tumorCounts["GT"],
            "tumor count Pred": self.tumorCounts["Pred"],
            "tumor count accuracy": self.tumorCounts["Accuracy"],
            "ratio Gold - 1": self.ratio["GTImmo"],
            "ratio Pred - 1": self.ratio["PredImmo"],
            "ratio accuracy - 1": self.ratio["AccuracyImmo"],
            "ratio Gold - 2": self.ratio["GTImmoTummor"],
            "ratio Pred -2": self.ratio["PredImmoTummor"],
            "ratio accuracy - 2": self.ratio["AccuracyImmoTummor"],
        }
        pd.DataFrame(performace_results).to_csv(
            os.path.join(self.save_dir, "resultsData.csv"), index=False)

        sf = self.smoothening_factor
        precision = self.tp / max(self.tp + self.fp, 1)
        recall = self.tp / max(self.tp + self.fn, 1)
        f1score = 2 * precision * recall / max(precision + recall, sf)
        meanPrecision = np.mean(self.precision) if self.precision else 0.0
        meanRecall = np.mean(self.recall) if self.recall else 0.0
        meanf1 = np.mean(self.f1) if self.f1 else 0.0
        meanED = np.mean(self.edList) if self.edList else 0.0

        plt = _plt()
        plt.hist(self.edList, bins=20)
        plt.savefig(os.path.join(self.save_dir, "EDhist.png"))
        plt.close("all")

        filt = {k: [min(x, 5) for x in v["Accuracy"]] for k, v in
                (("cell", self.cellCounts), ("immune", self.immuneCounts),
                 ("tumor", self.tumorCounts))}
        classP, classR, classF = [], [], []
        for cls in self.classRes:
            tp, fp, fn = (self.classRes[cls][k] for k in ("tp", "fp", "fn"))
            r = round(tp / max(tp + fn, 1), 4)
            p = round(tp / (tp + fp + sf), 4)
            f = round(2 * p * r / (p + r + sf), 4)
            classP.append(p)
            classR.append(r)
            classF.append(f)

        def mean(v):
            return round(sum(v) / max(len(v), 1), 4)

        self.performace_results = {
            # the reference's class loop SHADOWS its global precision/recall
            # before building this dict (test_mc3serousv5.py:341-343,348), so
            # its results.csv 'precision'/'recall' are the LAST class's
            # (tumor) values while 'f1' still uses the pre-loop globals —
            # replicated verbatim as part of the artifact contract
            # (tests/test_reports_vs_reference.py pins it)
            "precision": classP[-1] * 100,
            "recall": classR[-1] * 100,
            "f1": round(f1score, 4) * 100,
            "mean Precision": round(float(meanPrecision), 4) * 100,
            "mean Recall": round(float(meanRecall), 4) * 100,
            "mean f1": round(float(meanf1), 4) * 100,
            "mean IoU": round(float(meanED), 2),
            "Cell Precesion": classP[0] * 100,
            "Cell Recall": classR[0] * 100,
            "Cell F1": classF[0] * 100,
            "Cell Accuracy": mean(filt["cell"]),
            "Immune Precesion": classP[1] * 100,
            "Immune Recall": classR[1] * 100,
            "Immune F1": classF[1] * 100,
            "Immune Accuracy": mean(filt["immune"]),
            "Tumor Precesion": classP[2] * 100,
            "Tumor Recall": classR[2] * 100,
            "Tumor F1": classF[2] * 100,
            "Tumor Accuracy": mean(filt["tumor"]),
            "Ratio Accuracy-1": mean(self.ratio["AccuracyImmo"]),
            "Ratio Accuracy-2": mean(self.ratio["AccuracyImmoTummor"]),
        }
        pd.DataFrame(self.performace_results, index=[0]).to_csv(
            os.path.join(self.save_dir, "results.csv"), index=False)

    def get_results(self):
        return self.performace_results

    getResults = get_results


# ---------------------------------------------------------------------------
# density-regression results
# ---------------------------------------------------------------------------

class RegressionResults:
    """Density-map counting eval (ref test_reg3serousv5mt.py:186-624): per head,
    predicted count = sum(ReLU(out)/200); GAME grid; localisation via
    peak_local_max; Pearson r; CSV suite."""

    def __init__(self, save_dir, heads=("cell",)):
        self.save_dir = save_dir
        self.heads = heads
        self.data = {h: {k: [] for k in
                         ("GT", "Pred", "AbsDiff", "Accuracy",
                          "AccuracyRelative", "AccuracyRelativePD")}
                     for h in heads}
        self.Gmetrics = {h: {1: [], 2: [], 3: []} for h in heads}
        self.imageNames = []
        self.performace_results = {}

    def add(self, head, density_pred, gt_dot):
        count_pred = float(np.sum(density_pred))
        count_gt = float(np.sum(gt_dot))
        abs_diff, acc, rel, rpd = count_accuracy_metric(count_gt, count_pred)
        d = self.data[head]
        d["GT"].append(count_gt)
        d["Pred"].append(count_pred)
        d["AbsDiff"].append(abs_diff)
        d["Accuracy"].append(acc)
        d["AccuracyRelative"].append(rel)
        d["AccuracyRelativePD"].append(rpd)
        size = gt_dot.shape[0]
        for L in (1, 2, 3):
            self.Gmetrics[head][L].append(gmae(L, gt_dot, density_pred, size))

    def save(self):
        import pandas as pd
        from scipy.stats import pearsonr

        table = {"sample name": self.imageNames}
        for h in self.heads:
            d = self.data[h]
            table.update({
                f"{h} count Gold": d["GT"],
                f"{h} count Pred": d["Pred"],
                f"{h} abs diff": d["AbsDiff"],
                f"{h} accuracy": d["Accuracy"],
                f"{h} accuracy RD": d["AccuracyRelative"],
                f"{h} accuracy RD Perantage": d["AccuracyRelativePD"],
            })
        pd.DataFrame(table).to_csv(
            os.path.join(self.save_dir, "resultsData.csv"), index=False)

        grid_rows = {}
        for h in self.heads:
            for L in (1, 2, 3):
                arr = np.asarray(self.Gmetrics[h][L], dtype=float)
                grid_rows[f"{h} G({L})"] = arr.mean(axis=0) if len(arr) else \
                    np.zeros(3)
        pd.DataFrame(grid_rows, index=["gmae", "gmaeRelative", "gmaeRPD"]
                     ).transpose().to_csv(
            os.path.join(self.save_dir, "resultsGridCount.csv"), index=True)

        def mean(v):
            return round(sum(v) / max(len(v), 1), 4)

        res = {}
        plt = _plt()
        for h in self.heads:
            d = self.data[h]
            if len(d["GT"]) >= 2 and np.std(d["GT"]) > 0 and \
                    np.std(d["Pred"]) > 0:
                r = pearsonr(d["GT"], d["Pred"])[0]
            else:
                r = 0.0
            filt = [min(x, 5) for x in d["Accuracy"]]
            res.update({
                f"{h} MAE": mean(d["AbsDiff"]),
                f"{h} MRE": mean(filt),
                f"{h} MRE max": mean(d["AccuracyRelative"]),
                f"{h} RPD": mean(d["AccuracyRelativePD"]),
                f"{h} Pearson r": r,
            })
            plt.scatter(d["GT"], d["Pred"], c="black")
            plt.xlabel("golds")
            plt.ylabel("predictions")
            lim = int(max(max(d["GT"], default=0),
                          max(d["Pred"], default=0))) + 100
            plt.xlim(0, lim)
            plt.ylim(0, lim)
            plt.plot(range(lim))
            plt.savefig(os.path.join(self.save_dir, f"resultsData_{h}.png"))
            plt.cla()
        plt.close("all")
        self.performace_results = res
        pd.DataFrame(res, index=[0]).to_csv(
            os.path.join(self.save_dir, "results.csv"), index=False)

    def get_results(self):
        return self.performace_results


# ---------------------------------------------------------------------------
# ResultsCC — binary counting/localization accumulator (ref test.py:159-372)
# ---------------------------------------------------------------------------

class ResultsCC:
    def __init__(self, save_dir, save_img=False):
        self.save_dir = save_dir
        self.save_image = save_img
        self.imageNames = []
        self.recall, self.precision, self.f1 = [], [], []
        self.G1metrics, self.G2metrics, self.G3metrics = [], [], []
        self.GT, self.Pred = [], []
        self.AbsDiff, self.RelativeAccuracy = [], []
        self.sigma_list = [5, 20]
        self.sigma_thresh_list = list(np.arange(0.5, 1, 0.05))
        S, T = len(self.sigma_list), len(self.sigma_thresh_list)
        self.arr_prec = np.zeros((S, T))
        self.arr_recall = np.zeros((S, T))
        self.arr_f1 = np.zeros((S, T))
        self.performace_results = {}

    def _find_objects(self, img):
        from unet_torch_tpu_torch.eval.matching import (
            calculate_estimated_coordinates,
        )
        import cv2

        contours, _ = cv2.findContours(img.astype(np.uint8),
                                       cv2.RETR_EXTERNAL,
                                       cv2.CHAIN_APPROX_SIMPLE)
        coords = calculate_estimated_coordinates(img)
        return coords, len(contours)

    def compare_images(self, img_org, gt_img, pred_img, gt_dot):
        from unet_torch_tpu_torch.eval.matching import crowd_matching_greedy

        cellCountGt = int(np.sum(gt_dot))
        predLocalization, cellCountPred = self._find_objects(pred_img)
        abs_diff, acc, _, _ = count_accuracy_metric(cellCountGt,
                                                    cellCountPred)
        self.GT.append(cellCountGt)
        self.Pred.append(cellCountPred)
        self.AbsDiff.append(abs_diff)
        self.RelativeAccuracy.append(acc)

        e_dot = np.zeros_like(gt_dot)
        xs, ys = predLocalization
        for x, y in zip(xs, ys):
            e_dot[y, x] = 1
        size = gt_dot.shape[0]
        for L, store in ((1, self.G1metrics), (2, self.G2metrics),
                         (3, self.G3metrics)):
            store.append(gmae(L, gt_dot, e_dot, size)[0])

        p, r, f = crowd_matching_test(gt_dot, predLocalization,
                                      self.sigma_list,
                                      self.sigma_thresh_list,
                                      input_type="Coordinates")
        self.arr_prec += p
        self.arr_recall += r
        self.arr_f1 += f
        pr, rc, f1 = crowd_matching_greedy(gt_dot, predLocalization, 10)
        self.precision.append(pr)
        self.recall.append(rc)
        self.f1.append(f1)

        if self.save_image:
            plt = _plt()
            fig, axs = plt.subplots(1, 3)
            fig.set_figheight(12)
            fig.set_figwidth(30)
            if img_org.ndim == 3:
                axs[0].imshow(img_org[..., ::-1])
            else:
                axs[0].imshow(img_org, cmap="gray")
            axs[0].title.set_text("image")
            axs[1].imshow(gt_img)
            axs[1].title.set_text("label")
            fig.text(.51, .17, f"cell: {cellCountGt}", ha="center",
                     color="red")
            axs[2].imshow(pred_img)
            axs[2].title.set_text("prediction")
            fig.text(.79, .17, f"cell: {cellCountPred}", ha="center",
                     color="red")
            fig.savefig(os.path.join(self.save_dir, self.imageNames[-1]))
            plt.close(fig)

    compareImages = compare_images

    def save(self):
        import pandas as pd
        from scipy.stats import pearsonr

        pd.DataFrame({
            "sample name": self.imageNames,
            "cell count Gold": self.GT,
            "cell count Pred": self.Pred,
            "cell abs diff": self.AbsDiff,
            "cell accuracy": self.RelativeAccuracy,
            "precision": self.precision,
            "recall": self.recall,
            "f1": self.f1,
        }).to_csv(os.path.join(self.save_dir, "resultsData.csv"),
                  index=False)

        n = max(len(self.imageNames), 1)
        if len(self.GT) >= 2 and np.std(self.GT) > 0 and \
                np.std(self.Pred) > 0:
            pearson = pearsonr(self.GT, self.Pred)[0]
        else:
            # the reference's unguarded pearsonr returns NaN on constant
            # input (test.py:289) and pandas serialises it as an empty
            # cell — keep that exact artifact contract
            pearson = float("nan")
        self.arr_f1 /= n
        self.arr_prec /= n
        self.arr_recall /= n

        columns = ["prec_cell", "recall_cell", "f1_cell"]
        index = ["sigma(5)", "sigma(20)", "sigma(5)_09", "sigma(20)_09"]
        s5p, s20p = np.mean(self.arr_prec, axis=1)
        s5r, s20r = np.mean(self.arr_recall, axis=1)
        s5f, s20f = np.mean(self.arr_f1, axis=1)
        row1, row2 = [s5p, s5r, s5f], [s20p, s20r, s20f]
        s5p9, s20p9 = np.mean(self.arr_prec[:, :-1], axis=1)
        s5r9, s20r9 = np.mean(self.arr_recall[:, :-1], axis=1)
        s5f9, s20f9 = np.mean(self.arr_f1[:, :-1], axis=1)
        row3, row4 = [s5p9, s5r9, s5f9], [s20p9, s20r9, s20f9]
        pd.DataFrame([row1, row2, row3, row4], columns=columns,
                     index=index).to_csv(
            os.path.join(self.save_dir, "resultsMatching.csv"), index=True)

        def mean(v):
            return sum(v) / max(len(v), 1)

        self.performace_results = {
            "precsion": round(mean(self.precision), 4),
            "recall": round(mean(self.recall), 4),
            "f1": round(mean(self.f1), 4),
            "MAE": round(mean(self.AbsDiff), 4),
            "MRE": round(mean(self.RelativeAccuracy), 4),
            "pearsonr": round(float(pearson), 4),
            "GAME1": round(mean(self.G1metrics), 4),
            "GAME2": round(mean(self.G2metrics), 4),
            "GAME3": round(mean(self.G3metrics), 4),
            "precsion sigma5": round(row1[0], 4),
            "recall sigma5": round(row1[1], 4),
            "f1 sigma5": round(row1[2], 4),
            "precsion sigma5_9": round(row3[0], 4),
            "recall sigma5_9": round(row3[1], 4),
            "f1 sigma5_9": round(row3[2], 4),
            "precsion sigma20": round(row2[0], 4),
            "recall sigma20": round(row2[1], 4),
            "f1 sigma20": round(row2[2], 4),
        }
        pd.DataFrame([self.performace_results]).to_csv(
            os.path.join(self.save_dir, "resultsCount.csv"), index=True)

        plt = _plt()
        plt.scatter(self.GT, self.Pred, c="black")
        plt.xlabel("golds")
        plt.ylabel("predictions")
        lim = int(max(max(self.GT, default=0),
                      max(self.Pred, default=0))) + 100
        plt.xlim(0, lim)
        plt.ylim(0, lim)
        plt.plot(range(lim))
        plt.savefig(os.path.join(self.save_dir, "resultsData.png"))
        plt.close("all")

    def get_results(self):
        return self.performace_results

    getResults = get_results



def _load_eval_image(img_path, ch):
    import cv2

    if ch == 1:
        return cv2.imread(img_path, 0)
    return cv2.imread(img_path)


def create_label_coordinates_2class(tsv_path, shape=(768, 768)):
    """TSV -> (other, immune) dot maps with x,y halved
    (ref test_mc3serousv5.py:48-77); immune = 'Immune cells', rest other."""
    other = np.zeros(shape, np.float64)
    immune = np.zeros(shape, np.float64)
    with open(tsv_path) as f:
        header = f.readline().rstrip("\n").split("\t")
        xi, yi = header.index("x"), header.index("y")
        ci = header.index("class") if "class" in header else None
        for line in f:
            cols = line.rstrip("\n").split("\t")
            if len(cols) <= max(xi, yi) or not cols[xi]:
                continue
            x = min(max(int(np.rint(float(cols[xi]) / 2)) - 1, 0),
                    shape[1] - 1)
            y = min(max(int(np.rint(float(cols[yi]) / 2)) - 1, 0),
                    shape[0] - 1)
            cls = cols[ci] if ci is not None and len(cols) > ci else ""
            if cls == "Immune cells":
                immune[y, x] = 1
            else:
                other[y, x] = 1
    return other, immune


class TwoChannelRegResults:
    """Shared accumulator for the two-channel density-regression eval suites
    (test_single_reg, ref test_mc3serousv5.py:903-1335; test_multiple_reg,
    ref test_reg3serousv5mt.py:186-624): per-image other/immune counts from
    density sums, ratio metrics, GAME grids, sigma-grid Regression matching;
    emits resultsData.csv / resultsDataMean.csv / resultsGridCount.csv /
    resultsMatching.csv + scatter PNGs with the reference's exact columns."""

    def __init__(self, save_dir):
        self.save_dir = save_dir
        self.sample_list = []
        self.sigma_list = [5, 20]
        self.sigma_thresh_list = list(np.arange(0.5, 1, 0.05))
        S, T = len(self.sigma_list), len(self.sigma_thresh_list)
        self.data = {h: {k: [] for k in
                         ("GT", "Pred", "AbsDiff", "Accuracy",
                          "AccuracyRelative", "AccuracyRelativePD")}
                     for h in ("other", "immune", "ratio")}
        self.Gmetrics = {1: [], 2: [], 3: []}
        self.arr = {h: [np.zeros((S, T)) for _ in range(3)]
                    for h in ("other", "immune")}
        self.performace_results = {}

    def add(self, pred_other, pred_immune, gt_dot_other, gt_dot_immune):
        counts = {}
        for head, pred, dot in (("other", pred_other, gt_dot_other),
                                ("immune", pred_immune, gt_dot_immune)):
            gt_count = float(np.sum(dot))
            pr_count = float(np.sum(pred))
            counts[head] = (gt_count, pr_count)
            abs_diff, acc, rel, rpd = count_accuracy_metric(gt_count,
                                                            pr_count)
            d = self.data[head]
            d["GT"].append(round(gt_count, 4))
            d["Pred"].append(round(pr_count, 4))
            d["AbsDiff"].append(round(abs_diff, 4))
            d["Accuracy"].append(round(acc, 4))
            d["AccuracyRelative"].append(round(rel, 4))
            d["AccuracyRelativePD"].append(round(rpd, 4))

        (go, po), (gi, pi) = counts["other"], counts["immune"]
        ratio_gt = gi / max(go + gi, 1e-7)
        ratio_pr = pi / max(po + pi, 1e-7)
        abs_diff, acc, rel, rpd = count_accuracy_metric(ratio_gt, ratio_pr)
        d = self.data["ratio"]
        d["GT"].append(ratio_gt)
        d["Pred"].append(ratio_pr)
        d["AbsDiff"].append(abs_diff)
        d["Accuracy"].append(acc)
        d["AccuracyRelative"].append(rel)
        d["AccuracyRelativePD"].append(rpd)

        size = gt_dot_other.shape[0]
        for L in (1, 2, 3):
            self.Gmetrics[L].append(
                gmae(L, gt_dot_other, pred_other, size)
                + gmae(L, gt_dot_immune, pred_immune, size))

        for head, pred, dot in (("immune", pred_immune, gt_dot_immune),
                                ("other", pred_other, gt_dot_other)):
            p, r, f = crowd_matching_test(dot, pred.copy(), self.sigma_list,
                                          self.sigma_thresh_list,
                                          input_type="Regression")
            self.arr[head][0] += p
            self.arr[head][1] += r
            self.arr[head][2] += f

    def save(self):
        import pandas as pd
        from scipy.stats import pearsonr

        plt = _plt()
        for head, name, lims in (("immune", "resultsData_immune.png", None),
                                 ("immune", "resultsData_immune_200.png", 200),
                                 ("immune", "resultsData_immune_50.png", 50),
                                 ("other", "resultsData_other.png", None)):
            gt, pr = self.data[head]["GT"], self.data[head]["Pred"]
            plt.scatter(gt, pr, c="black")
            plt.xlabel("golds")
            plt.ylabel("predictions")
            max_limit = int(max(max(gt, default=0), max(pr, default=0))) + 100
            lim = lims or max_limit
            plt.xlim(0, lim)
            plt.ylim(0, lim)
            plt.plot(range(max_limit))
            plt.savefig(os.path.join(self.save_dir, name))
            plt.cla()
        plt.close("all")

        o, i, r = self.data["other"], self.data["immune"], self.data["ratio"]
        pd.DataFrame({
            "sample name": self.sample_list,
            "cell count Gold": o["GT"], "cell count Pred": o["Pred"],
            "cell abs diff": o["AbsDiff"], "cell accuracy": o["Accuracy"],
            "cell accuracy RD": o["AccuracyRelative"],
            "cell accuracy RD Perantage": o["AccuracyRelativePD"],
            "immune count Gold": i["GT"], "immune count Pred": i["Pred"],
            "immune abs diff": i["AbsDiff"], "immune accuracy": i["Accuracy"],
            "immune accuracy RD": i["AccuracyRelative"],
            "immune accuracy RD Perantage": i["AccuracyRelativePD"],
            "ratio Gold": r["GT"], "ratio Pred": r["Pred"],
            "ratio abs diff": r["AbsDiff"], "ratio accuracy": r["Accuracy"],
            "ratio accuracy RD": r["AccuracyRelative"],
            "ratio accuracy RD Perantage": r["AccuracyRelativePD"],
        }).to_csv(os.path.join(self.save_dir, "resultsData.csv"), index=False)

        def _pearson(a, b):
            if len(a) < 2 or np.std(a) == 0 or np.std(b) == 0:
                return 0.0
            return pearsonr(a, b)[0]

        def mean(v):
            return round(sum(v) / max(len(v), 1), 4)

        self.performace_results = {
            "Cell MAE": [mean(o["AbsDiff"])],
            "Cell MRE": [mean([min(x, 5) for x in o["Accuracy"]])],
            "Cell MRE max": [mean(o["AccuracyRelative"])],
            "Cell RPD": [mean(o["AccuracyRelativePD"])],
            "Cell Pearson r": [round(_pearson(o["GT"], o["Pred"]), 4)],
            "Immune MAE": [mean(i["AbsDiff"])],
            "Immune MRE": [mean([min(x, 5) for x in i["Accuracy"]])],
            "Immune MRE max": [mean(i["AccuracyRelative"])],
            "Immune RPD": [mean(i["AccuracyRelativePD"])],
            "Immune Pearson r": [round(_pearson(i["GT"], i["Pred"]), 4)],
            "Ratio MAE": [mean(r["AbsDiff"])],
            "Ratio MRE": [mean(r["Accuracy"])],
            "Ratio MRE max": [mean(r["AccuracyRelative"])],
            "Ratio RPD": [mean(r["AccuracyRelativePD"])],
            "Ratio pearson r": [round(_pearson(r["GT"], r["Pred"]), 4)],
        }
        pd.DataFrame(self.performace_results).to_csv(
            os.path.join(self.save_dir, "resultsDataMean.csv"), index=False)

        columns = ["gmae_cell", "gmae_cellAccuracyRelative",
                   "gmae_cellAccuracyRelativePD", "gmae_immune",
                   "gmae_immuneAccuracyRelative",
                   "gmae_immuneAccuracyRelativePD"]
        means = [pd.DataFrame(self.Gmetrics[L], columns=columns
                              ).mean().to_numpy() for L in (1, 2, 3)]
        pd.DataFrame(means, columns=columns,
                     index=["G(1)", "G(2)", "G(3)"]).to_csv(
            os.path.join(self.save_dir, "resultsGridCount.csv"), index=True)

        n = max(len(self.sample_list), 1)
        for head in ("other", "immune"):
            for a in self.arr[head]:
                a /= n
        columns = ["prec_cell", "recall_cell", "f1_cell", "prec_immune",
                   "recall_immune", "f1_immune"]
        index = ["sigma(5)", "sigma(20)", "sigma(5)_09", "sigma(20)_09"]

        def sig_rows(sl):
            po_, ro_, fo_ = [np.mean(a[:, sl], axis=1)
                             for a in self.arr["other"]]
            pi_, ri_, fi_ = [np.mean(a[:, sl], axis=1)
                             for a in self.arr["immune"]]
            return ([po_[0], ro_[0], fo_[0], pi_[0], ri_[0], fi_[0]],
                    [po_[1], ro_[1], fo_[1], pi_[1], ri_[1], fi_[1]])

        row1, row2 = sig_rows(slice(None))
        row3, row4 = sig_rows(slice(None, -1))
        pd.DataFrame([row1, row2, row3, row4], columns=columns,
                     index=index).to_csv(
            os.path.join(self.save_dir, "resultsMatching.csv"), index=True)

        # <25-immune-count filter pass (ref test_reg3serousv5mt.py:553-624):
        # drop images whose immune GT or prediction counts fewer than 25
        # cells, then re-emit the per-image table and the column means as
        # resultsDataFiltered.csv / resultsDataMeanFiltered.csv.
        keep = [j for j in range(len(self.sample_list))
                if i["GT"][j] >= 25 and i["Pred"][j] >= 25]

        def sel(v):
            return [v[j] for j in keep]

        pd.DataFrame({
            "sample name": sel(self.sample_list),
            "cell count Gold": sel(o["GT"]), "cell count Pred": sel(o["Pred"]),
            "cell abs diff": sel(o["AbsDiff"]),
            "cell accuracy": sel(o["Accuracy"]),
            "cell accuracy RD": sel(o["AccuracyRelative"]),
            "cell accuracy RD Perantage": sel(o["AccuracyRelativePD"]),
            "immune count Gold": sel(i["GT"]),
            "immune count Pred": sel(i["Pred"]),
            "immune abs diff": sel(i["AbsDiff"]),
            "immune accuracy": sel(i["Accuracy"]),
            "immune accuracy RD": sel(i["AccuracyRelative"]),
            "immune accuracy RD Perantage": sel(i["AccuracyRelativePD"]),
            "ratio Gold": sel(r["GT"]), "ratio Pred": sel(r["Pred"]),
            "ratio abs diff": sel(r["AbsDiff"]),
            "ratio accuracy": sel(r["Accuracy"]),
            "ratio accuracy RD": sel(r["AccuracyRelative"]),
            "ratio accuracy RD Perantage": sel(r["AccuracyRelativePD"]),
        }).to_csv(os.path.join(self.save_dir, "resultsDataFiltered.csv"),
                  index=False)

        pd.DataFrame({
            "Cell Absolute Difference": [mean(sel(o["AbsDiff"]))],
            "Cell Accuracy": [mean(sel(o["Accuracy"]))],
            "Cell Accuracy RD": [mean(sel(o["AccuracyRelative"]))],
            "Cell Accuracy RPD": [mean(sel(o["AccuracyRelativePD"]))],
            "Immune Absolute Difference": [mean(sel(i["AbsDiff"]))],
            "Immune Accuracy": [mean(sel(i["Accuracy"]))],
            "Immune Accuracy RD": [mean(sel(i["AccuracyRelative"]))],
            "Immune Accuracy RPD": [mean(sel(i["AccuracyRelativePD"]))],
            "Ratio Absolute Difference": [mean(sel(r["AbsDiff"]))],
            "Ratio Accuracy": [mean(sel(r["Accuracy"]))],
            "Ratio Accuracy RD": [mean(sel(r["AccuracyRelative"]))],
            "Ratio Accuracy RPD": [mean(sel(r["AccuracyRelativePD"]))],
        }).to_csv(os.path.join(self.save_dir, "resultsDataMeanFiltered.csv"),
                  index=False)

    def get_results(self):
        return self.performace_results


def _gt_dots_for(img_path, tsv_files, shape):
    """TSV dot maps when annotations exist (ref path), else split the
    class-coded *_gt_dot.png (1=other, 2=immune)."""
    import cv2

    name = os.path.basename(img_path).split(".png")[0]
    if tsv_files and name in tsv_files:
        return create_label_coordinates_2class(tsv_files[name], shape)
    dot = cv2.imread(img_path.replace(".png", "_gt_dot.png"), 0)
    if dot is None:
        return np.zeros(shape), np.zeros(shape)
    other = (dot == 1).astype(np.float64)
    immune = (dot == 2).astype(np.float64)
    if immune.sum() == 0 and other.sum() == 0:
        other = (dot > 0).astype(np.float64)
    return other, immune

