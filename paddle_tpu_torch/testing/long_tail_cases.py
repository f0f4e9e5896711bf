"""Sweep cases of the long-tail op modules: ``ops/linalg.py``'s solvers
and ``histogram``, ``ops/loss.py``'s recursions and sampled losses,
``ops/math_extra.py`` and ``ops/detection.py``. Each case runs the JAX
op of the registry name and the port's on the same seeded numpy inputs
(``test_torch_ops_cases.run``), forward and, where the JAX op is
differentiable, the gradients of sum(out * c). Tolerances: rtol 1e-5 /
atol 1e-6 unless the case says otherwise (the iterative solvers and the
series of the special functions 1e-4).

The tests ``tests/test_torch_ops_{linalg_tail,math_extra,detection}.py``
and ``tests/test_torch_ctc_crf.py`` run the groups against JAX,
``tests/test_torch_ops_registry.py`` holds them with the other groups to
the whole registry, and chip_smoke.py's phase 28(f) runs every case on
CUDA tensors against the same call on CPU tensors (JAX-free, so the card
machine can import it). ``OWN_TESTS`` names the ops with tests of their own:
the decompositions unique only up to signs (held by reconstruction),
the random draws (held in distribution), the ragged sequence ops and the
list-returning host ops.
"""
import numpy as np

from .op_cases import Case, Raw, bools, f32, ints, pos, rs

X = f32(3, 4)
Y = f32(3, 4, seed=1)
P = pos(3, 4)
V = f32(5)


def _spd(n, seed):
    a = f32(n, n, seed=seed)
    return (a @ a.T + n * np.eye(n)).astype(np.float32)


SPD = _spd(3, 30)
WELL = (f32(3, 3, seed=31) + 3 * np.eye(3)).astype(np.float32)
SYM = (lambda a: ((a + a.T) / 2).astype(np.float32))(f32(4, 4, seed=32))
UPPER = np.triu(WELL).astype(np.float32)
RANK2 = (f32(4, 2, seed=33) @ f32(2, 5, seed=34)).astype(np.float32)
_SOLVE = dict(rtol=1e-4, atol=1e-5)

LINALG_TAIL = [
    Case("cholesky", (SPD,), grad=(0,), **_SOLVE),
    Case("cholesky", (SPD,), {"upper": True}, grad=(0,), id="upper",
         **_SOLVE),
    Case("inverse", (WELL,), grad=(0,), **_SOLVE),
    Case("pinv", (f32(4, 3, seed=35),), grad=(0,), **_SOLVE),
    Case("matrix_power", (WELL, 3), grad=(0,), **_SOLVE),
    Case("matrix_power", (WELL, -2), grad=(0,), id="negative", **_SOLVE),
    Case("det", (WELL,), grad=(0,), **_SOLVE),
    Case("det", (np.stack([WELL, SPD]),), grad=(0,), id="batched",
         **_SOLVE),
    Case("slogdet", (WELL,), grad=(0,), **_SOLVE),
    Case("eigvalsh", (SYM,), grad=(0,), **_SOLVE),
    Case("eigvalsh", (SYM,), {"UPLO": "U"}, id="upper", **_SOLVE),
    Case("matrix_rank", (RANK2,)),
    Case("matrix_rank", (WELL,), {"tol": 2.5}, id="tol"),
    Case("solve", (WELL, f32(3, 2, seed=36)), grad=(0, 1), **_SOLVE),
    Case("triangular_solve", (UPPER, f32(3, 2, seed=37)), grad=(0, 1),
         **_SOLVE),
    Case("triangular_solve", (UPPER, f32(3, 2, seed=37)),
         {"transpose": True, "unitriangular": True}, grad=(1,),
         id="transpose_unit", **_SOLVE),
    Case("triangular_solve", (UPPER.T.copy(), f32(3, seed=38)),
         {"upper": False}, grad=(1,), id="lower_vector", **_SOLVE),
    Case("lstsq", (f32(5, 3, seed=39), f32(5, 2, seed=40)), grad=(0, 1),
         **_SOLVE),
    Case("lstsq", (RANK2.T.copy(), f32(5, seed=41)), {"rcond": 1e-3},
         id="rank_deficient", **_SOLVE),
    Case("histogram", (f32(40, seed=42),), {"bins": 7}),
    Case("histogram", (f32(40, seed=42),), {"bins": 4, "min": -0.5,
                                            "max": 0.5}, id="range"),
    Case("histogram", (np.full(6, 2.0, np.float32),), {"bins": 3},
         id="flat"),
]

# CTC: T 12, B 4, C 5 (blank 0); row 2 is infeasible (3 frames for 4
# labels), row 3 has no label
CTC_LOGITS = f32(12, 4, 5, seed=50) * 2
CTC_LABELS = ints(4, 4, lo=1, hi=5, seed=51)
CTC_LABELS[0, 1] = CTC_LABELS[0, 0]           # a repeat needs a blank
CTC_IN = np.array([12, 9, 3, 7], np.int64)
CTC_LAB = np.array([4, 2, 4, 0], np.int64)
CRF_EM = f32(3, 5, 4, seed=52) * 2
CRF_TR = f32(6, 4, seed=53)
CRF_Y = ints(3, 5, hi=4, seed=54)
CRF_LEN = np.array([5, 3, 1], np.int64)
_REC = dict(rtol=1e-4, atol=1e-5)

LOSS_TAIL = [
    Case("ctc_loss", (CTC_LOGITS, CTC_LABELS, CTC_IN, CTC_LAB),
         {"reduction": "none"}, grad=(0,), **_REC),
    Case("ctc_loss", (CTC_LOGITS, CTC_LABELS, CTC_IN, CTC_LAB),
         grad=(0,), id="mean", **_REC),
    Case("ctc_loss", (CTC_LOGITS, CTC_LABELS, CTC_IN, CTC_LAB),
         {"reduction": "sum", "norm_by_times": True}, grad=(0,),
         id="sum_norm_by_times", **_REC),
    Case("ctc_loss", (CTC_LOGITS[:, :2], CTC_LABELS[:2], CTC_IN[:2],
                      CTC_LAB[:2]), {"blank": 4, "reduction": "none"},
         grad=(0,), id="blank4", **_REC),
    Case("warpctc", (CTC_LOGITS, CTC_LABELS, CTC_IN, CTC_LAB),
         {"norm_by_times": True}, grad=(0,), **_REC),
    Case("linear_chain_crf", (CRF_EM, CRF_TR, CRF_Y, CRF_LEN),
         grad=(0, 1), **_REC),
    Case("linear_chain_crf", (CRF_EM, CRF_TR, CRF_Y), grad=(0, 1),
         id="full_length", **_REC),
    Case("viterbi_decode", (CRF_EM, CRF_TR, CRF_LEN), **_REC),
    Case("viterbi_decode", (CRF_EM, CRF_TR), id="full_length", **_REC),
    Case("viterbi_decode", (np.zeros((2, 4, 3), np.float32),
                            np.zeros((5, 3), np.float32)), id="ties"),
    Case("center_loss", (f32(5, 3, seed=55), ints(5, 1, hi=4, seed=56),
                         f32(4, 3, seed=57)), grad=(0, 2)),
    Case("center_loss", (f32(5, 3, seed=55), ints(5, 1, hi=4, seed=56),
                         f32(4, 3, seed=57)), {"update_center": False},
         grad=(0, 2), id="frozen"),
    Case("nce", (f32(4, 3, seed=58), ints(4, 1, hi=10, seed=59),
                 f32(10, 3, seed=60), f32(10, seed=61)),
         {"sample_ids": ints(5, hi=10, seed=62)}, grad=(0, 2, 3)),
    Case("nce", (f32(4, 3, seed=58), ints(4, 1, hi=10, seed=59),
                 f32(10, 3, seed=60)),
         {"sample_ids": ints(3, hi=10, seed=63)}, grad=(0, 2),
         id="no_bias"),
    Case("hsigmoid_loss", (f32(4, 3, seed=64), ints(4, hi=6, seed=65),
                           f32(5, 3, seed=66), f32(5, seed=67)),
         {"num_classes": 6}, grad=(0, 2, 3)),
    Case("hsigmoid_loss", (f32(4, 3, seed=64), ints(4, hi=2, seed=65),
                           f32(1, 3, seed=66)),
         {"num_classes": 2}, grad=(0, 2), id="two_classes"),
]

NAN = X.copy()
NAN[0, 1] = np.nan
_SP = dict(rtol=1e-4, atol=1e-6)
_TREE = np.array([[0, 0, 0, 1, 2], [1, 1, 0, 3, 4], [2, 1, 0, 5, 6],
                  [3, 2, 1, 0, 0], [4, 2, 1, 0, 0], [5, 2, 2, 0, 0],
                  [6, 2, 2, 0, 0]], np.int64)
_TRAVEL = np.array([[1, 3], [1, 4], [2, 5], [2, 6], [1, 3], [2, 6],
                    [1, 4]], np.int64)
_EDGES = np.array([[[1, 2], [1, 3], [1, 4], [2, 5], [0, 0]],
                   [[1, 2], [2, 3], [2, 4], [0, 0], [0, 0]]], np.int64)
_LU = (f32(3, 3, seed=70) + 2 * np.eye(3)).astype(np.float32)
_TAGS = ints(2, 9, hi=5, seed=71)

MATH_EXTRA = [
    Case("polygamma", (P,), {"n": 1}, grad=(0,), **_SP),
    Case("polygamma", (P,), {"n": 2}, id="n2", **_SP),
    Case("gammaln", (P,), grad=(0,), **_SP),
    Case("igamma", (P, pos(3, 4, seed=1)), grad=(1,), **_SP),
    Case("igammac", (P, pos(3, 4, seed=1)), grad=(1,), **_SP),
    Case("i0", (X * 3,), grad=(0,), **_SP),
    Case("i0e", (X * 3,), grad=(0,), **_SP),
    Case("i1", (X * 3,), grad=(0,), **_SP),
    Case("i1e", (X * 3,), grad=(0,), **_SP),
    Case("sinc", (np.append(X.reshape(-1), 0.0).astype(np.float32),),
         grad=(0,), **_SP),
    Case("nextafter", (X, Y)),
    Case("hypot", (X, Y), grad=(0, 1)),
    Case("copysign", (X, Y), grad=(0,)),
    Case("signbit", (np.array([-1.0, -0.0, 0.0, 2.0], np.float32),)),
    Case("ldexp", (X, ints(3, 4, lo=-2, hi=3, seed=2)), grad=(0,)),
    Case("fix", (X * 3,), grad=(0,)),
    Case("frexp", (X * 3,)),
    Case("vander", (V,), {"n": 4}, grad=(0,)),
    Case("vander", (V[:3],), {"increasing": True}, grad=(0,),
         id="increasing"),
    Case("renorm", (X, 2.0, 0, 1.0), grad=(0,)),
    Case("trapezoid", (X,), grad=(0,)),
    Case("trapezoid", (X,), {"x": np.sort(V[:4])}, grad=(0,), id="x"),
    Case("trapezoid", (X,), {"dx": 0.5, "axis": 0}, grad=(0,), id="axis0"),
    Case("cumulative_trapezoid", (X,), {"dx": 0.5}, grad=(0,)),
    Case("cumulative_trapezoid", (X,), {"x": np.sort(V[:3]), "axis": 0},
         grad=(0,), id="x"),
    Case("cummax", (X,), {"axis": 1}, grad=(0,)),
    Case("cummax", (np.array([1.0, 3.0, 3.0, 2.0, 5.0], np.float32),),
         id="flat_ties"),
    Case("cummin", (X,), {"axis": 0}, grad=(0,)),
    Case("nanmedian", (X,), {"axis": 1}, grad=(0,)),
    Case("nanmedian", (NAN,), {"axis": 1, "keepdim": True}, id="nan"),
    Case("nanmedian", (f32(5, seed=3),), id="all"),
    Case("nanquantile", (X,), {"q": 0.3, "axis": 0}, grad=(0,)),
    Case("nanquantile", (NAN,), {"q": np.array([0.25, 0.75]), "axis": 1},
         id="nan_list"),
    Case("histogramdd", (f32(20, 2, seed=4),), {"bins": 3}),
    Case("histogramdd", (f32(20, 2, seed=4),),
         {"bins": [3, 3], "ranges": [[-1.0, 1.0], [-0.5, 0.5]],
          "density": True}, id="ranges_density"),
    Case("bucketize", (X, np.sort(V))),
    Case("bucketize", (X, np.sort(V)), {"right": True, "out_int32": True},
         id="right_int32"),
    Case("index_add", (X, np.array([0, 2, 0]), 0, f32(3, 4, seed=5)),
         grad=(0, 3)),
    Case("index_fill", (X, np.array([1, 3]), 1, 2.5), grad=(0,)),
    Case("index_put", (X, Raw((np.array([0, 2]), np.array([1, 3]))),
                       f32(2, seed=6)), grad=(0,)),
    Case("index_put", (X, Raw((np.array([0, 0]), np.array([1, 1]))),
                       f32(2, seed=6)), {"accumulate": True}, grad=(0,),
         id="accumulate"),
    Case("masked_scatter", (X, bools(3, 4, seed=7), f32(12, seed=8)),
         grad=(0, 2)),
    Case("diagonal_scatter", (X, f32(3, seed=9)), grad=(0, 1)),
    Case("diagonal_scatter", (X, f32(3, seed=9)), {"offset": 1},
         grad=(0, 1), id="offset"),
    Case("select_scatter", (X, f32(4, seed=10), 0, 1), grad=(0, 1)),
    Case("slice_scatter", (X, f32(3, 2, seed=11), [1], [1], [4], [2]),
         grad=(0, 1)),
    Case("unflatten", (X, 1, [2, 2]), grad=(0,)),
    Case("view_as", (X, f32(2, 6, seed=12))),
    Case("cdist", (X, f32(5, 4, seed=13)), grad=(0, 1)),
    Case("cdist", (X, f32(5, 4, seed=13)), {"p": 1.0}, grad=(0, 1),
         id="p1"),
    Case("pdist", (f32(4, 3, seed=14),), grad=(0,)),
    Case("corrcoef", (X,), grad=(0,)),
    Case("corrcoef", (X,), {"rowvar": False}, id="cols"),
    Case("cov", (X,), grad=(0,)),
    Case("cov", (X,), {"rowvar": False, "ddof": False}, grad=(0,),
         id="cols_ddof0"),
    Case("cov", (X,), {"fweights": ints(4, lo=1, hi=4, seed=15),
                       "aweights": pos(4, seed=16)}, grad=(0,),
         id="weights"),
    Case("cholesky_solve", (f32(3, 2, seed=17), np.linalg.cholesky(
        SPD).astype(np.float32)), grad=(0, 1), **_SOLVE),
    Case("cholesky_solve", (f32(3, 2, seed=17), np.linalg.cholesky(
        SPD).T.copy().astype(np.float32)), {"upper": True}, grad=(0, 1),
         id="upper", **_SOLVE),
    Case("lu", (_LU,), grad=(0,), **_SOLVE),
    Case("lu_unpack", (_LU, np.array([2, 3, 3], np.int32)), grad=(0,)),
    Case("fold", (f32(1, 8, 9, seed=18),),
         {"output_sizes": [4, 4], "kernel_sizes": 2}, grad=(0,)),
    Case("fold", (f32(2, 4, 6, seed=19),),
         {"output_sizes": [3, 5], "kernel_sizes": [2, 2], "strides": 2,
          "paddings": 1}, grad=(0,), id="strided"),
    Case("channel_shuffle", (f32(2, 4, 3, 3, seed=20),), {"groups": 2},
         grad=(0,)),
    Case("channel_shuffle", (f32(2, 3, 3, 4, seed=20),),
         {"groups": 2, "data_format": "NHWC"}, id="nhwc"),
    Case("pixel_unshuffle", (f32(1, 2, 4, 4, seed=21),),
         {"downscale_factor": 2}, grad=(0,)),
    Case("affine_grid", (f32(2, 2, 3, seed=22),),
         {"out_shape": [2, 1, 3, 4]}, grad=(0,)),
    Case("affine_grid", (f32(2, 2, 3, seed=22),),
         {"out_shape": [2, 1, 3, 4], "align_corners": False}, grad=(0,),
         id="unaligned"),
    Case("grid_sample", (f32(2, 3, 5, 5, seed=23),
                         f32(2, 4, 4, 2, seed=24) * 1.1), grad=(0, 1)),
    Case("grid_sample", (f32(2, 3, 5, 5, seed=23),
                         f32(2, 4, 4, 2, seed=24) * 1.1),
         {"mode": "nearest"}, grad=(0,), id="nearest"),
    Case("grid_sample", (f32(2, 3, 5, 5, seed=23),
                         f32(2, 4, 4, 2, seed=24) * 1.1),
         {"padding_mode": "border", "align_corners": False}, grad=(0, 1),
         id="border"),
    Case("trace", (X,), grad=(0,)),
    Case("trace", (f32(2, 3, 3, seed=25),), {"offset": 1, "axis1": 1,
                                              "axis2": 2}, grad=(0,),
         id="batched"),
    Case("diag_embed", (f32(2, 3, seed=26),), grad=(0,)),
    Case("diag_embed", (f32(2, 3, seed=26),), {"offset": -1, "dim1": 0,
                                               "dim2": 2}, grad=(0,),
         id="offset"),
    Case("multiplex", (Raw([X, Y, X * 2]), np.array([[2], [0], [1]]))),
    Case("cos_sim", (X, Y), grad=(0, 1)),
    Case("bilinear_tensor_product", (f32(3, 4, seed=27), f32(3, 5, seed=28),
                                     f32(2, 4, 5, seed=29), f32(2, seed=30)),
         grad=(0, 1, 2, 3)),
    Case("squared_l2_norm", (X,), grad=(0,)),
    Case("squared_l2_distance", (X, Y), grad=(0, 1)),
    Case("l1_norm", (X,), grad=(0,)),
    Case("clip_by_norm", (X, 0.5), grad=(0,)),
    Case("clip_by_norm", (X * 0.1, 5.0), id="unclipped"),
    Case("edit_distance", (ints(3, 5, hi=4, seed=31),
                           ints(3, 4, hi=4, seed=32))),
    Case("edit_distance", (ints(3, 5, hi=4, seed=31),
                           ints(3, 4, hi=4, seed=32)),
         {"normalized": False}, id="raw"),
    Case("mean_iou", (ints(10, hi=4, seed=33), ints(10, hi=4, seed=34), 5)),
    Case("cvm", (pos(3, 5, seed=35),), grad=(0,)),
    Case("cvm", (pos(3, 5, seed=35),), {"use_cvm": False}, id="drop"),
    Case("hash_bucket", (ints(4, 1, hi=1000000, seed=36),),
         {"num_hash": 3}),
    Case("hash_bucket", (ints(4, 1, lo=2 ** 40, hi=2 ** 41, seed=37),),
         {"num_hash": 2, "mod_by": 1000}, id="wraparound"),
    Case("batch_fc", (f32(2, 3, 4, seed=38), f32(2, 4, 5, seed=39),
                      f32(2, 5, seed=40)), grad=(0, 1, 2)),
    Case("rank_attention", (f32(4, 3, seed=41),
                            ints(4, 3, lo=1, hi=3, seed=42),
                            f32(2, 3, 5, seed=43)), grad=(0, 2)),
    Case("match_matrix_tensor", (f32(2, 3, 4, seed=44),
                                 f32(2, 5, 4, seed=45),
                                 f32(4, 2, 4, seed=46)), grad=(0, 1, 2)),
    Case("fsp_matrix", (f32(2, 3, 4, 4, seed=47), f32(2, 5, 4, 4, seed=48)),
         grad=(0, 1)),
    Case("conv_shift", (f32(2, 6, seed=49), f32(2, 3, seed=50)),
         grad=(0, 1)),
    Case("filter_by_instag", (X, Raw([[1, 2], [3], [2, 5]]), Raw([2, 9]))),
    Case("fake_quantize_abs_max", (X,), grad=(0,)),
    Case("fake_quantize_abs_max", (X,), {"bit_length": 4}, id="4bit"),
    Case("fake_quantize_moving_average_abs_max",
         (X, np.array(0.8, np.float32)), grad=(0,)),
    Case("fake_channel_wise_quantize_abs_max", (X,), {"quant_axis": 1},
         grad=(0,)),
    Case("dequantize_abs_max", (ints(3, 4, lo=-127, hi=128, seed=51,
                                     dtype=np.int8),
                                np.array(0.5, np.float32), 127.0)),
    Case("fake_quantize_range_abs_max", (X, np.array(0.5, np.float32)),
         grad=(0,)),
    Case("fake_quantize_range_abs_max", (X, np.array(0.5, np.float32)),
         {"is_test": True}, id="test"),
    Case("fake_quantize_dequantize_abs_max", (X,), grad=(0,)),
    Case("fake_quantize_dequantize_moving_average_abs_max",
         (X, np.array(0.8, np.float32)), {"moving_rate": 0.5}, grad=(0,)),
    Case("fake_channel_wise_quantize_dequantize_abs_max", (X,), grad=(0,)),
    Case("fake_channel_wise_dequantize_max_abs",
         (ints(3, 4, lo=-127, hi=128, seed=52, dtype=np.int8), pos(4)),
         {"quant_axis": 1}),
    Case("fake_dequantize_max_abs",
         (ints(3, 4, lo=-127, hi=128, seed=53, dtype=np.int8),
          np.array(0.25, np.float32), 127.0)),
    Case("tdm_child", (ints(2, 2, hi=7, seed=54), _TREE, 2)),
    Case("tdm_sampler", (ints(4, hi=7, seed=55), Raw(_TRAVEL),
                         Raw([[1, 2], [3, 4, 5, 6]]), Raw([1, 2]),
                         Raw([2, 4]), 4), {"seed": 5}),
    Case("chunk_eval", (_TAGS, ints(2, 9, hi=5, seed=72)),
         {"num_chunk_types": 2}),
    Case("chunk_eval", (_TAGS, _TAGS), {"num_chunk_types": 2,
                                        "seq_lengths": np.array([9, 4])},
         id="exact_lengths"),
    Case("gru_unit", (f32(3, 6, seed=56), f32(3, 2, seed=57),
                      f32(2, 6, seed=58), f32(6, seed=59)),
         grad=(0, 1, 2, 3)),
    Case("lstm_unit", (f32(3, 8, seed=60), f32(3, 2, seed=61)),
         {"forget_bias": 1.0}, grad=(0, 1)),
    Case("accuracy", (f32(6, 5, seed=62), ints(6, 1, hi=5, seed=63)),
         {"k": 2}),
    Case("auc", (np.stack([1 - pos(30, seed=64) / 2, pos(30, seed=64) / 2],
                          1), ints(30, hi=2, seed=65)),
         {"num_thresholds": 50}),
    Case("tree_conv", (f32(2, 5, 3, seed=66), _EDGES, f32(3, 3, 2, 2,
                                                          seed=67)),
         grad=(0, 2)),
    # quantization/'s op, straight-through: the gradient passes inside the
    # scale and is 0 outside; a per-channel scale broadcasts
    Case("fake_quant", (X * 2, np.array(0.6, np.float32)), grad=(0,)),
    Case("fake_quant", (X, np.abs(X).max(0, keepdims=True)), {"bits": 4},
         grad=(0,), id="per_channel"),
]

_BOXES = np.array([[0.1, 0.1, 0.4, 0.5], [0.12, 0.08, 0.42, 0.5],
                   [0.5, 0.5, 0.9, 0.8], [0.52, 0.55, 0.88, 0.83],
                   [0.0, 0.6, 0.3, 0.95], [0.2, 0.2, 0.35, 0.45]],
                  np.float32)
_SCORES = np.array([0.9, 0.85, 0.7, 0.95, 0.3, 0.6], np.float32)
_PRIORS = np.array([[0.1, 0.1, 0.3, 0.4], [0.4, 0.2, 0.8, 0.6],
                    [0.2, 0.5, 0.6, 0.9]], np.float32)
_PVAR = np.tile(np.array([0.1, 0.1, 0.2, 0.2], np.float32), (3, 1))
_ROIS = np.array([[1.0, 1.0, 6.0, 5.0], [0.5, 2.0, 7.5, 7.0],
                  [2.0, 0.0, 4.0, 7.0]], np.float32)
_GT = np.array([[[0.3, 0.4, 0.2, 0.3], [0.7, 0.6, 0.5, 0.4],
                 [0.0, 0.0, 0.0, 0.0]],
                [[0.5, 0.5, 0.1, 0.2], [0.2, 0.8, 0.3, 0.3],
                 [0.9, 0.1, 0.4, 0.6]]], np.float32)
_ANC3 = (np.abs(f32(3, 3, 2, 4, seed=80)) * 10
         + np.array([0, 0, 12, 12], np.float32)).astype(np.float32)
_GEO = dict(rtol=1e-5, atol=1e-5)

DETECTION = [
    Case("iou_similarity", (_BOXES[:4], _PRIORS), grad=(0, 1)),
    Case("iou_similarity", (_BOXES[:4] * 10, _PRIORS * 10),
         {"box_normalized": False}, grad=(0,), id="pixels"),
    Case("box_coder", (_PRIORS, _PVAR, _BOXES[:2]), grad=(2,)),
    Case("box_coder", (_PRIORS, None, _BOXES[:2]),
         {"box_normalized": False}, id="encode_novar"),
    Case("box_coder", (_PRIORS, _PVAR, f32(2, 3, 4, seed=81)),
         {"code_type": "decode_center_size"}, grad=(2,), id="decode"),
    Case("box_coder", (_PRIORS, _PVAR[:1].copy(), f32(3, 2, 4, seed=82)),
         {"code_type": "decode_center_size", "axis": 1}, grad=(2,),
         id="decode_axis1"),
    Case("prior_box", (f32(1, 2, 3, 4), f32(1, 3, 12, 16), [4.0], [8.0],
                       (1.0, 2.0)), {"flip": True, "clip": True}, **_GEO),
    Case("yolo_box", (f32(2, 16, 4, 4, seed=83) * 2,
                      ints(2, 2, lo=300, hi=400, seed=84),
                      [10, 13, 16, 30], 3), grad=(0,), **_GEO),
    Case("yolo_box", (f32(2, 16, 4, 4, seed=83) * 2,
                      ints(2, 2, lo=300, hi=400, seed=84),
                      [10, 13, 16, 30], 3),
         {"conf_thresh": 0.5, "clip_bbox": False, "scale_x_y": 1.05},
         grad=(0,), id="noclip", **_GEO),
    Case("box_clip", (_BOXES * 30 - 2, np.array([[20.0, 25.0, 1.0]],
                                                np.float32)), grad=(0,)),
    Case("roi_align", (f32(2, 3, 8, 8, seed=85), _ROIS, Raw([2, 1])),
         {"output_size": 2}, grad=(0, 1), **_GEO),
    Case("roi_align", (f32(1, 3, 8, 8, seed=85), _ROIS),
         {"output_size": [2, 3], "spatial_scale": 0.5, "sampling_ratio": 3,
          "aligned": False}, grad=(0, 1), id="unaligned", **_GEO),
    Case("roi_pool", (f32(2, 3, 8, 8, seed=86), _ROIS, Raw([1, 2])),
         {"output_size": 2}, grad=(0,)),
    Case("nms", (_BOXES, 0.3, _SCORES)),
    Case("nms", (_BOXES, 0.3, _SCORES),
         {"category_idxs": np.array([0, 0, 1, 1, 0, 1]), "top_k": 3},
         id="categories"),
    Case("multiclass_nms", (np.stack([_BOXES, _BOXES[::-1].copy()]),
                            rs(87).rand(2, 3, 6).astype(np.float32)),
         {"score_threshold": 0.2, "keep_top_k": 4}),
    Case("bipartite_match", (rs(88).rand(3, 4).astype(np.float32),)),
    Case("anchor_generator", (f32(1, 2, 3, 4), [32, 64], [0.5, 1.0])),
    Case("density_prior_box", (f32(1, 2, 3, 4), f32(1, 3, 12, 16), [2, 1],
                               [8.0, 16.0], [1.0]), {"clip": True},
         **_GEO),
    Case("matrix_nms", (_BOXES, rs(89).rand(2, 6).astype(np.float32)),
         {"score_threshold": 0.1, "keep_top_k": 5}),
    Case("matrix_nms", (_BOXES, rs(89).rand(2, 6).astype(np.float32)),
         {"score_threshold": 0.1, "use_gaussian": True}, id="gaussian"),
    Case("target_assign", (f32(2, 3, 4, seed=90),
                           ints(2, 5, lo=-1, hi=3, seed=91)), grad=(0,)),
    Case("polygon_box_transform", (f32(1, 4, 3, 5, seed=92),), grad=(0,)),
    Case("collect_fpn_proposals", (Raw([_BOXES[:3], _BOXES[3:]]),
                                   Raw([_SCORES[:3], _SCORES[3:]]), 4)),
    Case("box_decoder_and_assign", (_PRIORS, _PVAR, f32(3, 8, seed=93),
                                    f32(3, 2, seed=94)), grad=(2,)),
    Case("mine_hard_examples", (f32(2, 6, seed=95),
                                ints(2, 6, lo=-1, hi=2, seed=96))),
    Case("yolov3_loss", (f32(2, 16, 4, 4, seed=97), _GT,
                         ints(2, 3, hi=3, seed=98), [10, 13, 16, 30, 33, 23],
                         [0, 1], 3), grad=(0,), rtol=1e-5, atol=1e-5),
    Case("yolov3_loss", (f32(2, 16, 4, 4, seed=97), _GT,
                         ints(2, 3, hi=3, seed=98), [10, 13, 16, 30, 33, 23],
                         [1, 2], 3), {"use_label_smooth": True}, grad=(0,),
         id="smooth", rtol=1e-5, atol=1e-5),
    Case("generate_proposals", (rs(99).rand(1, 2, 3, 3).astype(np.float32),
                                f32(1, 8, 3, 3, seed=100) * 0.2,
                                np.array([[40.0, 40.0]], np.float32), _ANC3,
                                np.ones((3, 3, 2, 4), np.float32)),
         {"pre_nms_top_n": 10, "post_nms_top_n": 5,
          "return_rois_num": True}),
    Case("retinanet_detection_output",
         (Raw([f32(1, 6, 4, seed=101) * 0.1]),
          Raw([rs(102).rand(1, 6, 3).astype(np.float32)]),
          Raw([_BOXES * 30]), np.array([[40.0, 40.0, 1.0]], np.float32)),
         {"score_threshold": 0.3}),
]

GROUPS = {"linalg_tail": LINALG_TAIL, "loss_tail": LOSS_TAIL,
          "math_extra": MATH_EXTRA, "detection": DETECTION}

OWN_TESTS = {
    # unique up to signs and order (test_torch_ops_linalg_tail.py)
    "svd", "qr", "eigh",
    # random draws (test_torch_ops_math_extra.py)
    "standard_gamma", "binomial", "log_normal",
    # a host callback (test_torch_ops_math_extra.py)
    "py_func",
    # a list of per-level tensors (test_torch_ops_detection.py)
    "distribute_fpn_proposals",
    # ragged in, ragged out (test_torch_sequence.py)
    "sequence_pool", "sequence_softmax", "sequence_expand",
    "sequence_concat", "sequence_reverse", "sequence_first_step",
    "sequence_last_step", "sequence_slice", "sequence_pad",
    "sequence_unpad", "sequence_mask", "sequence_expand_as",
    "sequence_enumerate", "sequence_erase", "sequence_reshape",
    "sequence_scatter", "sequence_conv", "sequence_topk_avg_pooling",
}
