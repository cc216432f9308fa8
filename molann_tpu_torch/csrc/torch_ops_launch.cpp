// Launches of the fused kernels for the torch custom ops of the engine
// artifact (torch_ops_cuda.cpp): K1 and K4 (fused_unrolled.cu), K6 and K8
// (fused_blocked.cu), through the kernel library's extern "C" entry points.
//
// An artifact carries a model's tables as tensors and its sizes and
// offsets as a list of ints (ops/fused.py and ops/fused_blocked.py
// artifact_tables); the Python route keeps the same tables in device
// tensors and fills ctypes mirrors of ModelArgs and BlockedArgs. Each call
// here rebuilds the struct from the tensors' addresses, then chooses the
// launch on the device it runs on as the Python route does: the unrolled
// kernels' grid from molann_fused_grid (asked once per device, kernel and
// state size, which also sets the kernel's shared memory limit there), the
// blocked kernels' tile as choose_frames and set_tile choose it. So an
// artifact exported on a machine without a card runs on any card, and on
// the same frames launches the kernel the Python route launches, with the
// same arguments. Compiled with a host C++ compiler: it includes the
// kernels' headers for their structs and host sizing functions, and no
// CUDA header (blocked_math.cuh defines a host float4).

#include "torch_ops_launch.h"

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>
#include <vector>

#include "blocked_math.cuh"

extern "C" {
// The kernel library (ops/_build.py load_library).
int molann_caps(int* out);
int molann_fused_grid(const ModelArgs* m, int forces, int device, int* out);
int molann_fused_forward(const ModelArgs* m, const UnrIO* io, int forces, int warps, int blocks,
                         int device, void* stream);
int molann_blocked_caps(int* out);
int molann_blocked_forward(const BlockedArgs* m, const BlockedIO* io, int device, void* stream);
int molann_blocked_cv_forces(const BlockedArgs* m, const BlockedIO* io, int device, void* stream);
}

namespace {

// ops/fused.py UNROLLED_META, in its order.
enum UnrMeta {
  U_FORMAT, U_N_ATOMS, U_N_ANGLES, U_N_BONDS, U_N_DIHEDRALS, U_N_POS, U_N_ALIGN, U_N_COORD,
  U_USE_ANGLE_VALUE, U_N_FEAT, U_N_LAYERS, U_ACTIVATION, U_DIM0,
  U_N_SLOTS = U_DIM0 + MOLANN_MAX_LAYERS + 1, U_D_OUT,
  U_ANGLE_OFF, U_BOND_OFF, U_DIHEDRAL_OFF, U_POS_OFF, U_ALIGN_OFF, U_COL_OF_OFF,
  U_COORD_START_OFF, U_COORD_PAIRS_OFF, U_SLOT_COL_OFF, U_COL_SLOT_OFF,
  U_COORD_PAR_OFF, U_REF_X_OFF, U_W_OFF, U_B_OFF = U_W_OFF + MOLANN_MAX_LAYERS,
  U_LEN = U_B_OFF + MOLANN_MAX_LAYERS
};
constexpr int64_t kUnrolledFormat = 1;  // UNROLLED_FORMAT

// The groups of features a blocked tile may ask for (BATCH_GROUPS).
constexpr int kGroups[] = {8, 16, 32, 64, 128, 256, 512};
constexpr int kNGroups = (int)(sizeof(kGroups) / sizeof(kGroups[0]));

// ops/fused_blocked.py BLOCKED_META, in its order; the head table follows.
enum BlkMeta {
  B_FORMAT, B_N_ACT, B_N_OUT, B_N_ANGLES, B_N_BONDS, B_N_DIHEDRALS, B_N_COORD, B_N_POS, B_N_ALIGN,
  B_USE_ANGLE_VALUE, B_N_FEAT, B_N_LAYERS, B_ACTIVATION, B_N_ATOMS, B_D_OUT, B_HAS_ACTIVE,
  B_PAIR_HEAVY, B_HAS_PAIRS, B_N_PAIR_OPERAND,
  // _INT_TABLES
  B_ACTIVE_IDX_OFF, B_OUT_MAP_OFF, B_ANGLE_OFF, B_BOND_OFF, B_DIHEDRAL_OFF, B_POS_OFF,
  B_ALIGN_OFF, B_ITEM_COL_OFF, B_ATOM_PTR_OFF, B_ATOM_ENT_OFF, B_COORD_RANGE_OFF,
  B_HEAD_OFF, B_BATCHES, B_COORD_PAR_OFF = B_BATCHES + 2 * kNGroups, B_REF_X_OFF, B_PARAMS_OFF,
  B_LEN
};
constexpr int64_t kBlockedFormat = 1;  // BLOCKED_FORMAT

// ops/fused_blocked.py: the shared memory a block may use, a quarter and a
// half of an SM's, and the blocks a launch should have before its tile grows.
constexpr long long kSmemMax = 232448;
constexpr long long kSmemQuarter = MOLANN_BLK_SMEM_QUARTER;
constexpr long long kSmemHalf = 113 * 1024;
constexpr long long kMinBlocks = 128;

std::mutex g_mutex;
int g_caps = 1;  // 1: not checked yet, then 0 or MOLANN_OP_BAD_CAPS
std::map<std::tuple<int, int, int>, std::vector<int>> g_grids;

// The kernel library's envelope and struct sizes against this file's, once
// (ops/fused.py and ops/fused_blocked.py _library check the same).
int check_caps() {
  std::lock_guard<std::mutex> lock(g_mutex);
  if (g_caps == 1) {
    int u[6] = {0}, b[5] = {0};
    molann_caps(u);
    molann_blocked_caps(b);
    const int want_u[6] = {MOLANN_MAX_ATOMS, MOLANN_MAX_COLS, MOLANN_MAX_WIDTH, MOLANN_MAX_LAYERS,
                           (int)sizeof(ModelArgs), (int)sizeof(UnrIO)};
    const int want_b[5] = {MOLANN_COORD_FLOATS, MOLANN_BLK_THREADS, (int)sizeof(BlockedArgs),
                           (int)sizeof(BlockedIO), MOLANN_BLK_GRAD_BLOCKS};
    g_caps = (std::equal(u, u + 6, want_u) && std::equal(b, b + 5, want_b)) ? 0
                                                                           : MOLANN_OP_BAD_CAPS;
  }
  return g_caps;
}

int blocked_meta_len(const int64_t* meta, int n_meta) {
  if (n_meta < B_LEN || meta[B_FORMAT] != kBlockedFormat) return -1;
  return B_LEN + 8 * (int)std::max<int64_t>(1, meta[B_N_LAYERS]);
}

bool unrolled_meta_ok(const int64_t* meta, int n_meta) {
  return n_meta == U_LEN && meta[U_FORMAT] == kUnrolledFormat &&
         meta[U_N_LAYERS] >= 0 && meta[U_N_LAYERS] <= MOLANN_MAX_LAYERS;
}

template <typename T>
const T* table_at(const T* base, int64_t off) {
  return off < 0 ? nullptr : base + off;
}

// The slot form of the model's tables, as ops/fused.py _Statics.slot_args
// and model_args fill it.
ModelArgs unrolled_args(const int64_t* meta, const int* ints, const float* floats) {
  ModelArgs m{};
  m.n_atoms = (int)meta[U_N_ATOMS];
  m.n_angles = (int)meta[U_N_ANGLES];
  m.n_bonds = (int)meta[U_N_BONDS];
  m.n_dihedrals = (int)meta[U_N_DIHEDRALS];
  m.n_pos = (int)meta[U_N_POS];
  m.n_align = (int)meta[U_N_ALIGN];
  m.n_coord = (int)meta[U_N_COORD];
  m.use_angle_value = (int)meta[U_USE_ANGLE_VALUE];
  m.n_feat = (int)meta[U_N_FEAT];
  m.n_layers = (int)meta[U_N_LAYERS];
  m.activation = (int)meta[U_ACTIVATION];
  for (int i = 0; i <= MOLANN_MAX_LAYERS; ++i) m.dims[i] = (int)meta[U_DIM0 + i];
  m.angle_idx = table_at(ints, meta[U_ANGLE_OFF]);
  m.bond_idx = table_at(ints, meta[U_BOND_OFF]);
  m.dihedral_idx = table_at(ints, meta[U_DIHEDRAL_OFF]);
  m.pos_idx = table_at(ints, meta[U_POS_OFF]);
  m.align_idx = table_at(ints, meta[U_ALIGN_OFF]);
  m.col_of = table_at(ints, meta[U_COL_OF_OFF]);
  m.coord_start = table_at(ints, meta[U_COORD_START_OFF]);
  m.coord_pairs = table_at(ints, meta[U_COORD_PAIRS_OFF]);
  m.coord_par = table_at(floats, meta[U_COORD_PAR_OFF]);
  m.ref_x = m.n_align ? table_at(floats, meta[U_REF_X_OFF]) : nullptr;
  for (int i = 0; i < m.n_layers; ++i) {
    m.w[i] = table_at(floats, meta[U_W_OFF + i]);
    m.b[i] = table_at(floats, meta[U_B_OFF + i]);
  }
  m.n_slots = (int)meta[U_N_SLOTS];
  m.slot_col = table_at(ints, meta[U_SLOT_COL_OFF]);
  m.col_slot = table_at(ints, meta[U_COL_SLOT_OFF]);
  return m;
}

// ops/fused_blocked.py choose_frames for the forward (forces = 0) and
// cv+forces kernels, with molann_blocked_smem_bytes's sizing; sets
// frames and pitch. Returns the frames, or 0 where one frame does not fit.
int choose_frames(BlockedArgs& a, bool forces, int64_t l, bool pairs) {
  auto smem = [&](int frames) {
    a.frames = frames;
    a.pitch = frames | 1;
    return (long long)blk_smem(a, blk_threads(a, forces), forces).total * (long long)sizeof(float);
  };
  std::vector<long long> shares;
  if (pairs) shares.push_back(kSmemHalf);
  shares.push_back(kSmemQuarter);
  if (forces) shares.push_back(kSmemHalf);
  int frames = 0;
  for (long long share : shares)
    for (int cand : {32, 16, 8})
      if (!frames && smem(cand) <= share) frames = cand;
  if (!frames)
    for (int cand : {32, 16, 8, 4, 2, 1})
      if (smem(cand) <= kSmemMax) {
        frames = cand;
        break;
      }
  while (frames > 1 && l < frames * kMinBlocks) frames /= 2;
  if (frames) {
    a.frames = frames;
    a.pitch = frames | 1;
  }
  return frames;
}

}  // namespace

extern "C" {

const char* molann_op_message(int rc) {
  switch (rc) {
    case MOLANN_OP_BAD_META:
      return "the artifact's meta is not of this op library's format";
    case MOLANN_OP_BAD_CAPS:
      return "the kernel library's caps or struct sizes differ from the op library's";
    case MOLANN_OP_NO_TILE:
      return "one frame of this model does not fit a block's shared memory";
    case MOLANN_OP_NO_BATCHES:
      return "the artifact carries no batches of features for this tile";
    case MOLANN_OP_BAD_OPERAND:
      return "the pair operand's length is not the model's";
    default:
      return "";
  }
}

int molann_op_shape(const int64_t* meta, int n_meta, int blocked, int64_t* n_atoms,
                    int64_t* d_out, int64_t* n_pairs) {
  if (blocked) {
    if (blocked_meta_len(meta, n_meta) != n_meta) return MOLANN_OP_BAD_META;
    *n_atoms = meta[B_N_ATOMS];
    *d_out = meta[B_D_OUT];
    *n_pairs = meta[B_HAS_PAIRS] ? meta[B_N_PAIR_OPERAND] : 0;
    return 0;
  }
  if (!unrolled_meta_ok(meta, n_meta)) return MOLANN_OP_BAD_META;
  *n_atoms = meta[U_N_ATOMS];
  *d_out = meta[U_D_OUT];
  *n_pairs = 0;
  return 0;
}

int molann_op_unrolled(const int64_t* meta, int n_meta, const int* ints, const float* floats,
                       const float* x, float* y, float* gx, int64_t l, int forces, int device,
                       void* stream) {
  if (!unrolled_meta_ok(meta, n_meta)) return MOLANN_OP_BAD_META;
  if (int rc = check_caps()) return rc;
  const ModelArgs m = unrolled_args(meta, ints, floats);
  // K1's or K4's grid on this device for this state size, asked once
  const auto key = std::make_tuple(device, forces, uw_layout(m, forces != 0).pitch);
  std::vector<int> grid;
  {
    std::lock_guard<std::mutex> lock(g_mutex);
    auto it = g_grids.find(key);
    if (it != g_grids.end()) grid = it->second;
  }
  if (grid.empty()) {
    int got[3] = {0, 0, 0};
    if (int rc = molann_fused_grid(&m, forces, device, got)) return rc;
    grid.assign(got, got + 3);
    std::lock_guard<std::mutex> lock(g_mutex);
    g_grids[key] = grid;
  }
  UnrIO io{};
  io.x = x;
  io.y = y;
  io.gx = forces ? gx : nullptr;
  io.l = l;
  io.component = -1;
  return molann_fused_forward(&m, &io, forces, grid[0], grid[1] * grid[2], device, stream);
}

int molann_op_blocked(const int64_t* meta, int n_meta, const int* ints, const float* floats,
                      const int* pairs, const float* x, float* y, float* gx, int64_t l,
                      int forces, int device, void* stream) {
  if (blocked_meta_len(meta, n_meta) != n_meta) return MOLANN_OP_BAD_META;
  if (int rc = check_caps()) return rc;
  // the head table, in host memory for the host's sizing
  std::vector<int> head_host(meta + B_LEN, meta + n_meta);
  BlockedArgs a{};
  a.n_act = (int)meta[B_N_ACT];
  a.n_out = (int)meta[B_N_OUT];
  a.n_angles = (int)meta[B_N_ANGLES];
  a.n_bonds = (int)meta[B_N_BONDS];
  a.n_dihedrals = (int)meta[B_N_DIHEDRALS];
  a.n_coord = (int)meta[B_N_COORD];
  a.n_pos = (int)meta[B_N_POS];
  a.n_align = (int)meta[B_N_ALIGN];
  a.use_angle_value = (int)meta[B_USE_ANGLE_VALUE];
  a.n_feat = (int)meta[B_N_FEAT];
  a.n_layers = (int)meta[B_N_LAYERS];
  a.activation = (int)meta[B_ACTIVATION];
  const bool active = meta[B_HAS_ACTIVE] != 0;
  a.active_idx = active ? ints + meta[B_ACTIVE_IDX_OFF] : nullptr;
  a.out_map = active ? ints + meta[B_OUT_MAP_OFF] : nullptr;
  a.angle_idx = ints + meta[B_ANGLE_OFF];
  a.bond_idx = ints + meta[B_BOND_OFF];
  a.dihedral_idx = ints + meta[B_DIHEDRAL_OFF];
  a.pos_idx = ints + meta[B_POS_OFF];
  a.align_idx = ints + meta[B_ALIGN_OFF];
  a.item_col = ints + meta[B_ITEM_COL_OFF];
  a.atom_ptr = ints + meta[B_ATOM_PTR_OFF];
  a.atom_ent = ints + meta[B_ATOM_ENT_OFF];
  a.coord_range = ints + meta[B_COORD_RANGE_OFF];
  a.head = ints + meta[B_HEAD_OFF];
  a.head_host = head_host.data();
  if (meta[B_HAS_PAIRS]) {
    if (!pairs) return MOLANN_OP_BAD_OPERAND;
    // [partner rows n_coord (n_act + 1) | owned ends n_coord n_act | partners]
    const int64_t n_ptr = (int64_t)a.n_coord * (a.n_act + 1);
    a.nbr_ptr = pairs;
    a.nbr_mid = pairs + n_ptr;
    a.nbr = pairs + 2 * n_ptr - a.n_coord;
  }
  a.coord_par = floats + meta[B_COORD_PAR_OFF];
  a.ref_x = floats + meta[B_REF_X_OFF];
  a.params = floats + meta[B_PARAMS_OFF];
  // the tile, and the batches of features for its threads (set_tile)
  if (!choose_frames(a, forces != 0, l, meta[B_PAIR_HEAVY] != 0)) return MOLANN_OP_NO_TILE;
  const int group = std::max(1, blk_threads(a, forces != 0) / a.frames);
  const int* g = std::find(kGroups, kGroups + kNGroups, group);
  if (g == kGroups + kNGroups) return MOLANN_OP_NO_BATCHES;
  const int64_t boff = meta[B_BATCHES + 2 * (g - kGroups)];
  a.n_batches = (int)meta[B_BATCHES + 2 * (g - kGroups) + 1];
  a.batch_ptr = ints + boff;
  a.batch_ent = ints + boff + a.n_batches + 1;
  const int64_t n3 = 3 * meta[B_N_ATOMS];
  BlockedIO io{};
  io.x = x;
  io.l = l;
  io.x_sf = n3;
  io.x_sa = 3;
  io.x_sc = 1;
  io.y = y;
  io.y_sf = meta[B_D_OUT];
  io.y_sj = 1;
  if (forces) {
    io.gx = gx;
    io.g_sf = n3;
    io.g_sa = 3;
    io.g_sc = 1;
  }
  io.component = -1;
  return forces ? molann_blocked_cv_forces(&a, &io, device, stream)
                : molann_blocked_forward(&a, &io, device, stream);
}

}  // extern "C"
