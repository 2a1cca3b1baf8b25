"""All configuration knobs of the port, as dataclasses.

The port's own copy of `contour_context_tpu/config.py`: the same classes,
fields, defaults and checks, so a config built here equals, field by field,
the JAX package's config built from the same arguments
(tests/test_torch_copies.py holds the two together). The reference scatters
these knobs over a YAML file (`config/batch_bin_test_config.yaml`),
compile-time macros (`CMakeLists.txt:15-21`) and hardcoded constants
(`contour_mng.h:112-115`, `correlation.h:17-18`, `contour_db.h:160-163`).

Some fields choose between lowerings of the JAX package (`use_pallas_ring`,
`cc_flush`, `topk_strategy`, `desc_batch`); the port has one lowering of
each and keeps the fields only so that the two configs stay equal.
Reference parity notes are `file:line` citations into the reference repo.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

# Fixed-shape capacity constants of the dense per-scan layout: the reference
# uses variable-size vectors, the port fixed-shape tensors with validity
# masks. Truncation beyond a cap is counted and reported.
MAX_CONTOURS_PER_LEVEL = 64   # contours kept per height level (sorted by cell count)
BITS_PER_LAYER = 64           # contour_mng.h:112
DIST_BIN_LAYERS = (1, 2, 3, 4)  # contour_mng.h:113
LAYER_AREA_WEIGHTS = (0.3, 0.3, 0.3, 0.1)  # contour_mng.h:114
NUM_BIN_KEY_LAYER = len(DIST_BIN_LAYERS)
RET_KEY_DIM = 10              # contour_mng.h:89


@dataclass(frozen=True)
class ContourViewStatConfig:
    """Per-contour statistics knobs (contour.h:32-37)."""
    min_cell_cov: int = 4
    point_sigma: float = 1.0
    com_bias_thres: float = 0.5


@dataclass(frozen=True)
class ContourSimThresConfig:
    """Pairwise contour similarity gate thresholds (contour.h:40-45)."""
    ta_cell_cnt: float = 6.0
    tp_cell_cnt: float = 0.2
    tp_eigval: float = 0.2
    ta_h_bar: float = 0.3      # 0.75 for MulRan
    ta_rcom: float = 0.4
    tp_rcom: float = 0.25


@dataclass(frozen=True)
class ContourManagerConfig:
    """Per-scan BEV / contour / key extraction knobs (contour_mng.h:92-110)."""
    lv_grads: Tuple[float, ...] = (1.5, 2.0, 2.5, 3.0, 3.5, 4.0)  # KITTI; MulRan: (1,2.5,4,5.5,7,8.5)
    reso_row: float = 1.0
    reso_col: float = 1.0
    n_row: int = 150
    n_col: int = 150
    lidar_height: float = 2.0
    blind_sq: float = 9.0
    min_cont_key_cnt: int = 9
    min_cont_cell_cnt: int = 3
    piv_firsts: int = 6
    dist_firsts: int = 10
    roi_radius: float = 10.0
    # capacity knobs (not in the reference; dense-table bounds)
    max_contours: int = MAX_CONTOURS_PER_LEVEL
    max_points: int = 131072   # point-cloud pad size (KITTI HDL-64E: ~120-130k)
    pix_pool: int = 4096       # above-gate pixel pool for the ring keys
    use_pallas_ring: bool = False  # JAX lowering choice; the port always
                                   # runs its ring kernel (ops/kernels.py)
    keys_bf16: bool = True     # keep the DB's search-layout key copy
                               # (ContourDB.keys_q) bfloat16; the archived
                               # ScanDesc.keys stay exact f32, and the
                               # cascade re-verifies every survivor exactly
    cc_flush: str = "hillis"   # JAX lowering choice of cc_labels; the port
                               # has one (label-identical) lowering
    view_stat: ContourViewStatConfig = field(default_factory=ContourViewStatConfig)

    def __post_init__(self):
        # the dense check-3 tables and BCI pair-slot encoding hold 10 seqs
        # (the reference's dist_firsts default); larger values would silently
        # alias slots — reject loudly (ops/candidate.N_SEQ)
        if self.dist_firsts > 10:
            raise ValueError("dist_firsts > 10 is not supported by the dense "
                             "pair-slot layout (see ops/candidate.N_SEQ)")
        if self.piv_firsts > 10:
            raise ValueError("piv_firsts > 10 exceeds the pair-slot layout")
        # ScanDesc.cnt is stored int16: a single connected component is
        # bounded by the grid cell count, which must fit
        if self.n_row * self.n_col > 32767:
            raise ValueError(
                "n_row * n_col > 32767 overflows the int16 cell counts of "
                "the archived store (types.ScanDesc.cnt)")

    @property
    def n_levels(self) -> int:
        return len(self.lv_grads)


@dataclass(frozen=True)
class TreeBucketConfig:
    """Temporal insertion-delay window (contour_db.h:54-57)."""
    max_elapse: float = 25.0
    min_elapse: float = 15.0


@dataclass(frozen=True)
class GMMOptConfig:
    """GMM L2 correlation knobs (correlation.h:15-20)."""
    min_area_perc: float = 0.95
    levels: Tuple[int, ...] = (1, 2, 3, 4)
    cov_dilate_scale: float = 2.0
    # capacity knobs
    max_gmm_ellipses: int = 32   # per level, ellipses kept to reach min_area_perc
    gn_iters: int = 10           # ceres: max_num_iterations=10 (correlation.h:215)


# --- score ensembles --------------------------------------------------------
# The reference packs these in unions (contour_mng.h:121-219); here plain dataclasses.

@dataclass(frozen=True)
class ScoreConstellSim:
    """BCI constellation consensus score (contour_mng.h:121-152)."""
    i_ovlp_sum: int = 3
    i_ovlp_max_one: int = 3
    i_in_ang_rng: int = 3

    def overall(self) -> int:
        return self.i_in_ang_rng


@dataclass(frozen=True)
class ScorePairwiseSim:
    """Pairwise correspondence score (contour_mng.h:154-186)."""
    i_indiv_sim: int = 3
    i_orie_sim: int = 4

    def overall(self) -> int:
        return self.i_orie_sim


@dataclass(frozen=True)
class ScorePostProc:
    """Post-processing screens (contour_mng.h:188-219)."""
    correlation: float = 0.3
    area_perc: float = 0.03
    neg_est_dist: float = -5.01

    def overall(self) -> float:
        return self.correlation


@dataclass(frozen=True)
class CandidateScoreEnsemble:
    """Combined check thresholds (contour_db.h:244-250)."""
    sim_constell: ScoreConstellSim = field(default_factory=ScoreConstellSim)
    sim_pair: ScorePairwiseSim = field(default_factory=ScorePairwiseSim)
    sim_post: ScorePostProc = field(default_factory=ScorePostProc)


DEFAULT_THRES_LB = CandidateScoreEnsemble(
    sim_constell=ScoreConstellSim(3, 3, 3),
    sim_pair=ScorePairwiseSim(3, 4),
    sim_post=ScorePostProc(0.3, 0.03, -5.01),
)  # batch_bin_test_config.yaml:70-78

DEFAULT_THRES_UB = CandidateScoreEnsemble(
    sim_constell=ScoreConstellSim(6, 6, 6),
    sim_pair=ScorePairwiseSim(6, 6),
    sim_post=ScorePostProc(0.75, 0.15, -5.0),
)  # batch_bin_test_config.yaml:79-87


@dataclass(frozen=True)
class ContourDBConfig:
    """Retrieval database knobs (contour_db.h:658-669)."""
    nnk: int = 50
    max_fine_opt: int = 10
    q_levels: Tuple[int, ...] = (1, 2, 3)
    cont_sim: ContourSimThresConfig = field(default_factory=ContourSimThresConfig)
    tb: TreeBucketConfig = field(default_factory=TreeBucketConfig)
    # capacity knobs
    max_check_cands: int = 256    # candidate hints compacted into the batched
                                  # check cascade; overflow keeps the
                                  # nearest-by-key-distance hits and is
                                  # counted in ContourDB.counters
    max_pass_hints: int = 128     # cascade survivors fed to the proposal merge
    max_cand_poses: int = 64      # candidate pose rows of the on-device
                                  # CandidateManager (the reference is
                                  # unbounded; overflow_cand counts drops)
    dynamic_thres: bool = False   # DYNAMIC_THRES compile flag (CMakeLists.txt:19,
                                  # contour_db.h:439-458); not ported yet
    topk_strategy: str = "cover2"  # JAX lowering choice of the exact min-k;
                                  # the port always runs the tile-min cover
                                  # of db._search_cover2 (db.search)
    cascade_chunk: int = 128      # check-cascade chunk width: the cascade
                                  # runs over ceil(n/W) chunks of W hints
                                  # (result-identical); 0 = unchunked
    check1_prefilter: bool = True  # run check 1 over all selected hints
                                  # first and feed only its survivors,
                                  # compacted in hint order, to the chunked
                                  # cascade (records are bit-identical)
    desc_batch: int = 1           # JAX chain lowering (vmapped descriptor
                                  # sub-batches); not used by the port
    p_pot: Optional[int] = 128    # angular-window pair capacity per hint in
                                  # the check-2/3 cascade (None = ops/
                                  # cascade.P_POT, 512); truncation is
                                  # counted in counters["overflow_pot"]

    def __post_init__(self):
        # check-3 stats tables cover the DIST_BIN_LAYERS levels only; an
        # anchor level outside them would silently gather a neighbor's stats
        # (ops/cascade.gather_tab maps level -> row level-1)
        bad = [q for q in self.q_levels if q not in DIST_BIN_LAYERS]
        if bad:
            raise ValueError(f"q_levels {bad} outside DIST_BIN_LAYERS "
                             f"{DIST_BIN_LAYERS} are not supported")


@dataclass(frozen=True)
class PipelineConfig:
    """Everything the end-to-end loop-closure pipeline needs."""
    cm: ContourManagerConfig = field(default_factory=ContourManagerConfig)
    db: ContourDBConfig = field(default_factory=ContourDBConfig)
    gmm: GMMOptConfig = field(default_factory=GMMOptConfig)
    thres_lb: CandidateScoreEnsemble = DEFAULT_THRES_LB
    thres_ub: CandidateScoreEnsemble = DEFAULT_THRES_UB
    correlation_thres: float = 0.64928  # batch_bin_test_config.yaml:66


def load_pipeline_config_yaml(path: str) -> Tuple[PipelineConfig, dict]:
    """Load a reference-format YAML config (batch_bin_test.cpp:38-100).

    Uses a tiny hand-rolled parser for the subset of YAML the reference uses
    (OpenCV FileStorage style: scalar keys, one nesting level, inline lists),
    so no YAML dependency is needed.  Returns the PipelineConfig plus a dict of
    the IO paths (fpath_sens_gt_pose / fpath_lidar_bins / fpath_outcome_sav).
    """
    raw: dict = {}
    stack: List[Tuple[int, dict]] = [(-1, raw)]
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].rstrip()
            if not line.strip() or line.strip().startswith(("%", "---")):
                continue
            indent = len(line) - len(line.lstrip())
            key, _, val = line.strip().partition(":")
            val = val.strip()
            while stack and stack[-1][0] >= indent:
                stack.pop()
            parent = stack[-1][1] if stack else raw
            if not val:
                child: dict = {}
                parent[key] = child
                stack.append((indent, child))
            else:
                if val.startswith("["):
                    parent[key] = [float(x) for x in val.strip("[]").split(",") if x.strip()]
                else:
                    try:
                        parent[key] = float(val) if ("." in val or "e" in val) else int(val)
                    except ValueError:
                        parent[key] = val.strip('"')

    def g(d, k, default):
        return d.get(k, default)

    cmr = raw.get("ContourManagerConfig", {})
    cm = ContourManagerConfig(
        lv_grads=tuple(g(cmr, "lv_grads_", (1.5, 2, 2.5, 3, 3.5, 4))),
        n_row=int(g(cmr, "n_row_", 150)),
        n_col=int(g(cmr, "n_col_", 150)),
        lidar_height=float(g(cmr, "lidar_height_", 2.0)),
        blind_sq=float(g(cmr, "blind_sq_", 9.0)),
        min_cont_key_cnt=int(g(cmr, "min_cont_key_cnt_", 9)),
        min_cont_cell_cnt=int(g(cmr, "min_cont_cell_cnt_", 3)),
        piv_firsts=int(g(cmr, "piv_firsts_", 6)),
        dist_firsts=int(g(cmr, "dist_firsts_", 10)),
        roi_radius=float(g(cmr, "roi_radius_", 10.0)),
    )
    dbr = raw.get("ContourDBConfig", {})
    simr = dbr.get("ContourSimThresConfig", {})
    tbr = dbr.get("TreeBucketConfig", {})
    db = ContourDBConfig(
        nnk=int(g(dbr, "nnk_", 50)),
        max_fine_opt=int(g(dbr, "max_fine_opt_", 10)),
        q_levels=tuple(int(x) for x in g(dbr, "q_levels_", (1, 2, 3))),
        cont_sim=ContourSimThresConfig(
            ta_cell_cnt=float(g(simr, "ta_cell_cnt", 6.0)),
            tp_cell_cnt=float(g(simr, "tp_cell_cnt", 0.2)),
            tp_eigval=float(g(simr, "tp_eigval", 0.2)),
            ta_h_bar=float(g(simr, "ta_h_bar", 0.3)),
            ta_rcom=float(g(simr, "ta_rcom", 0.4)),
            tp_rcom=float(g(simr, "tp_rcom", 0.25)),
        ),
        tb=TreeBucketConfig(
            max_elapse=float(g(tbr, "max_elapse_", 25.0)),
            min_elapse=float(g(tbr, "min_elapse_", 15.0)),
        ),
    )

    def ens(d) -> CandidateScoreEnsemble:
        return CandidateScoreEnsemble(
            sim_constell=ScoreConstellSim(
                int(d.get("i_ovlp_sum", 3)), int(d.get("i_ovlp_max_one", 3)), int(d.get("i_in_ang_rng", 3))
            ),
            sim_pair=ScorePairwiseSim(int(d.get("i_indiv_sim", 3)), int(d.get("i_orie_sim", 4))),
            sim_post=ScorePostProc(
                float(d.get("correlation", 0.3)),
                float(d.get("area_perc", 0.03)),
                float(d.get("neg_est_dist", -5.01)),
            ),
        )

    cfg = PipelineConfig(
        cm=cm,
        db=db,
        thres_lb=ens(raw.get("thres_lb_", {})),
        thres_ub=ens(raw.get("thres_ub_", {})),
        correlation_thres=float(g(raw, "correlation_thres", 0.64928)),
    )
    io_paths = {
        k: raw.get(k) for k in ("fpath_sens_gt_pose", "fpath_lidar_bins", "fpath_outcome_sav") if k in raw
    }
    return cfg, io_paths
