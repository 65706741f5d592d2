"""Erasure-coding geometry: RS(10,4), code configs, block layout.

Byte-layout-compatible with the reference (weed/storage/
erasure_coding/ec_encoder.go:17-23): a volume's .dat is
striped row-major — while more than one full large row (10 x 1GB) remains,
emit large rows; then 10 x 1MB small rows, the last one zero-padded. Data
shard i of a row holds block i; parity shards .ec10-.ec13 extend each row.

Beyond-reference: the same math generalizes to WIDE codes — every
function takes an optional `data_shards`, and `parse_codec("28.4")`
names an RS(28,4) volume tier for cold collections (BASELINE config #4:
wider stripes cost the same device dispatch but 1/7th the parity
overhead). The reference hard-codes 10+4.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

DATA_SHARDS = 10
PARITY_SHARDS = 4
TOTAL_SHARDS = DATA_SHARDS + PARITY_SHARDS
# widest supported code: ShardBits is a uint32 mask, shard_ext 2 digits
MAX_SHARD_COUNT = 32
LARGE_BLOCK = 1 << 30  # 1GB
SMALL_BLOCK = 1 << 20  # 1MB


def parse_codec(codec: str) -> tuple[int, int]:
    """Codec spec -> (data_shards, total_parity_shards).

    Accepts 'k.m' (RS), 'lrc-k.l.g' (LRC: l local XOR parities + g
    global RS parities, total parity l+g), or '' for the RS(10,4)
    default. Geometry (stripe layout, shard count) only
    needs (k, m); code structure lives in parse_code/CodeConfig.
    """
    if not codec:
        return DATA_SHARDS, PARITY_SHARDS
    if codec.startswith("lrc-"):
        code = parse_code(codec)
        return code.k, code.m
    k_s, _, m_s = codec.partition(".")
    k, m = int(k_s), int(m_s)
    if k <= 0 or m <= 0 or k + m > MAX_SHARD_COUNT:
        raise ValueError(
            f"codec {codec!r}: need k>0, m>0, k+m<={MAX_SHARD_COUNT}")
    return k, m


def codec_name(k: int, m: int) -> str:
    return f"{k}.{m}"


# ---------------------------------------------------------------------------
# Code configs: a code is (encode matrix, locality groups, repair plan)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RepairPlan:
    """How to heal `missing` shards: which surviving shards to read and
    whether the cheap local (XOR-group) path suffices. `reads` is the
    exact surviving-shard set a repair must fetch — the degraded-read
    ladder, the partial-stripe rebuilder and the tiering offload all
    size their IO from it instead of assuming k-of-n."""

    missing: tuple[int, ...]
    reads: tuple[int, ...]
    kind: str  # "local" (XOR group peel) or "global" (matrix solve)

    @property
    def fanin(self) -> int:
        return len(self.reads)


@dataclass(frozen=True)
class CodeConfig:
    """An erasure code: shard roles + locality structure.

    kind "rs": shards [0,k) data, [k,k+m) Reed-Solomon parity.
    kind "lrc" (lrc-k.l.g, arXiv 1309.0186): shards [0,k) data in l
    groups of k/l; shard k+i is the XOR parity of group i; shards
    [k+l, k+l+g) are global RS parities. A single loss inside a group
    repairs from the k/l surviving group members instead of k shards.

    The encode/recovery matrices live in ops.rs_matrix
    (encode_matrix_for / recovery_rows_for); this class is pure
    structure so geometry stays importable without numpy-heavy deps.
    """

    spec: str
    kind: str                      # "rs" | "lrc"
    k: int                         # data shards
    n_local: int                   # local (XOR) parity shards
    n_global: int                  # global (RS) parity shards

    @property
    def m(self) -> int:
        """Total parity shards (geometry-compatible with RS m)."""
        return self.n_local + self.n_global

    @property
    def total(self) -> int:
        return self.k + self.m

    @property
    def is_rs(self) -> bool:
        return self.kind == "rs"

    @property
    def group_size(self) -> int:
        """Data shards per locality group (k for RS: one implicit
        group, repairs read k shards either way)."""
        return self.k // self.n_local if self.n_local else self.k

    @property
    def local_groups(self) -> tuple[tuple[int, ...], ...]:
        """Per group: (data members..., local parity id). Empty for
        RS — there is no sub-k repair group."""
        if not self.n_local:
            return ()
        gs = self.group_size
        return tuple(
            tuple(range(i * gs, (i + 1) * gs)) + (self.k + i,)
            for i in range(self.n_local))

    @property
    def global_parities(self) -> tuple[int, ...]:
        return tuple(range(self.k + self.n_local, self.total))

    def group_of(self, sid: int) -> tuple[int, ...] | None:
        """The locality group (data members + local parity) a shard
        belongs to; None for global parities and for RS shards."""
        for grp in self.local_groups:
            if sid in grp:
                return grp
        return None


    # -- repair planning ------------------------------------------------

    def recoverable(self, present) -> bool:
        """Whether the shards in `present` determine all k data shards
        — an actual GF(256) rank check against this code's encode
        matrix, not a count heuristic (LRC local-parity rows are
        dependent with their groups, so k survivors can be
        insufficient and k-1 survivors can suffice... never for data,
        but patterns matter)."""
        present = sorted(set(int(s) for s in present))
        if self.is_rs:
            return len(present) >= self.k
        if len(present) < self.k:
            return False
        from ..ops import rs_matrix

        return rs_matrix.rank_of(self, present) >= self.k

    def repair_plan(self, missing, available) -> RepairPlan | None:
        """The cheapest read set healing `missing` from `available`,
        or None when unrecoverable.

        Local peel first: any missing shard whose group is otherwise
        fully present (counting already-peeled repairs) heals from
        group_size reads. Whatever remains needs a global solve over a
        greedily-selected independent row set (rs_matrix picks the
        actual rows; the plan's `reads` is its input set)."""
        missing = tuple(sorted(set(int(s) for s in missing)))
        avail = set(int(s) for s in available) - set(missing)
        if not missing:
            return RepairPlan((), (), "local")
        reads: set[int] = set()
        healed: set[int] = set()
        have = set(avail)
        progress = True
        while progress:
            progress = False
            for sid in missing:
                if sid in healed:
                    continue
                grp = self.group_of(sid)
                if grp is None:
                    continue
                others = [x for x in grp if x != sid]
                if all(x in have for x in others):
                    reads.update(x for x in others if x in avail)
                    healed.add(sid)
                    have.add(sid)
                    progress = True
        rest = [sid for sid in missing if sid not in healed]
        if not rest:
            return RepairPlan(missing, tuple(sorted(reads)), "local")
        # global solve for the remainder: rs_matrix selects the input
        # rows (preferring shards the peel already read)
        from ..ops import rs_matrix

        inputs = rs_matrix.solve_inputs(self, sorted(avail), rest,
                                        prefer=sorted(reads))
        if inputs is None:
            return None
        reads.update(inputs)
        return RepairPlan(missing, tuple(sorted(reads)), "global")


@lru_cache(maxsize=64)
def parse_code(spec: str) -> CodeConfig:
    """Codec spec -> CodeConfig. '' -> RS(10,4); 'k.m' -> RS(k,m);
    'lrc-k.l.g' -> LRC with l local XOR groups and g global parities
    (k divisible by l). The same strings are recorded in volume .vif
    files, so mixed-code clusters decode correctly."""
    if not spec:
        # canonical spec: '' and '10.4' are the same code, one identity
        return CodeConfig(codec_name(DATA_SHARDS, PARITY_SHARDS),
                          "rs", DATA_SHARDS, 0, PARITY_SHARDS)
    if spec.startswith("lrc-"):
        parts = spec[len("lrc-"):].split(".")
        if len(parts) != 3:
            raise ValueError(
                f"code {spec!r}: expected lrc-<k>.<locals>.<globals>")
        k, l, g = (int(p) for p in parts)
        if k <= 0 or l <= 0 or g <= 0:
            raise ValueError(f"code {spec!r}: need k, locals, globals > 0")
        if k % l:
            raise ValueError(
                f"code {spec!r}: k={k} not divisible into {l} local groups")
        if k + l + g > MAX_SHARD_COUNT:
            raise ValueError(
                f"code {spec!r}: k+locals+globals > {MAX_SHARD_COUNT}")
        return CodeConfig(spec, "lrc", k, l, g)
    k, m = parse_codec(spec)
    return CodeConfig(spec, "rs", k, 0, m)


def shard_ext(index: int) -> str:
    """Shard file extension '.ec00'..'.ec13' (ToExt, ec_encoder.go:65)."""
    return f".ec{index:02d}"


def row_layout(dat_size: int, large_block: int = LARGE_BLOCK,
               small_block: int = SMALL_BLOCK,
               data_shards: int = DATA_SHARDS) -> tuple[int, int]:
    """-> (n_large_rows, n_small_rows) for a .dat of dat_size bytes.

    Matches encodeDatFile's loop structure (ec_encoder.go:198-235): large
    rows are emitted while remaining > k*large_block (strictly), then
    small rows while remaining > 0, last one zero-padded.
    """
    remaining = dat_size
    n_large = 0
    while remaining > large_block * data_shards:
        n_large += 1
        remaining -= large_block * data_shards
    n_small = 0
    while remaining > 0:
        n_small += 1
        remaining -= small_block * data_shards
    return n_large, n_small


def shard_file_size(dat_size: int, large_block: int = LARGE_BLOCK,
                    small_block: int = SMALL_BLOCK,
                    data_shards: int = DATA_SHARDS) -> int:
    n_large, n_small = row_layout(dat_size, large_block, small_block,
                                  data_shards)
    return n_large * large_block + n_small * small_block


