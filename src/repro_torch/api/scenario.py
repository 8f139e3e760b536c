"""Declarative inference scenarios (paper Fig. 2: model × variant × traffic).

A :class:`Scenario` is the hardware-independent half of a forecast: which
architecture, which software/model-optimization :class:`Variant`, and what
traffic hits it (batch, prompt length, generation budget, chunked-prefill
chunk, LoRA adapter, mixed continuous-batching ``past_lens``).  It is the
single input consumed by :func:`repro_torch.api.forecast` (analytical path),
:func:`repro_torch.api.measure` (real engine) and :func:`repro_torch.api.sweep`
(hardware what-ifs), replacing the per-script
``configs.get → WorkloadModel → StatsDB → Forecaster`` wiring.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

from repro_torch import configs
from repro_torch.configs.base import ArchConfig, Variant, PAPER_VARIANTS


def zipf_adapter_ids(n_tenants: int, count: int, s: float = 0.0,
                     seed: int = 0) -> Tuple[int, ...]:
    """``count`` tenant ids drawn from a Zipf(``s``) popularity law.

    Tenant ``i`` has weight ``1/(i+1)**s`` (``s=0`` = uniform) — the
    standard skewed multi-tenant traffic assumption.  Pure Python and
    seeded, so the measured engine and the analytical forecast sample
    the *same* tenant stream.
    """
    import random
    if n_tenants < 1 or count < 1:
        return ()
    rng = random.Random(seed)
    weights = [1.0 / float(i + 1) ** s for i in range(n_tenants)]
    return tuple(rng.choices(range(n_tenants), weights=weights, k=count))


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One inference workload: architecture × variant × traffic shape.

    ``model`` / ``variant`` accept registry names (``"llama2-7b"``,
    ``"bf16-int4-kv4"``) or resolved ``ArchConfig`` / ``Variant`` objects.

    Traffic:
      * ``batch``       — concurrent sequences (decode slots for the engine)
      * ``prompt_len``  — prompt tokens per request (drives TTFT)
      * ``gen_len``     — generation budget per request (drives TPS)
      * ``chunk``       — chunked-prefill chunk size (§3.3.4); ``None`` = one shot
      * ``past_lens``   — per-slot KV lengths of ONE mixed continuous-batching
                          decode step; overrides ``batch`` (= ``len(past_lens)``)
      * ``lora_rank``   — include a one-time LoRA adapter merge (Eq. 7)
      * ``gen_lens``    — per-request budgets for the measured path (staggered
                          completions exercise slot reuse); overrides
                          ``n_requests``
      * ``shared_prefix_len`` — the requests share this many leading prompt
                          tokens (a common system prompt); with the
                          block-paged engine's radix prefix cache, warm
                          admissions skip the shared blocks, and the
                          analytical side forecasts the same hit
      * ``block_size``  — KV block size of the paged cache (``None``:
                          engine default)
      * ``prefix_cache`` — disable to measure/forecast the same traffic
                          cache-cold
      * ``attn_impl``   — engine attention read path to measure AND price:
                          ``"gather"`` (page rematerialization) or
                          ``"paged"`` (paged flash kernels).
                          ``None`` (default) measures the engine default
                          and forecasts the plain analytical scenario
                          (neither impl's overhead priced — pre-engine
                          numbers, bit-for-bit)
      * ``tp``          — tensor-parallel degree.  Forecasts price the
                          per-chip workload plus collective traffic
                          (``HardwareSpec.interconnect_GBps``); the
                          measured engine runs on a ``model=tp`` device
                          mesh, sharding weights + the block-paged KV pool
                          over KV heads.  ``tp=1`` (default) is the
                          single-chip paper scenario, bit-for-bit.
      * ``pp``          — pipeline-parallel degree.  Forecasts partition
                          the layer stack into ``pp`` stages, price the
                          inter-stage activation hops as ``wire_bytes``
                          and model the chunked-prefill microbatch bubble
                          ``(pp−1)/(m+pp−1)``; the measured engine runs
                          the stacked layer scan in ``pp`` segments
                          sharded over a ``pipe`` mesh axis, tokens
                          bit-identical to ``pp=1``.
    Speculative decoding (``spec_k > 0``): the measured engine runs the
    draft → batched-verify → accept loop (``spec_k`` drafts per slot per
    step); the forecast prices k draft steps plus one (k+1)-query verify
    at assumed acceptance ``spec_acceptance`` and reports the speedup
    curve and per-hardware break-even α.  ``prompt_motif_len`` makes the
    measured prompts repeat a short motif — a high-acceptance workload
    for the self-speculative n-gram drafter.

    Measured-path knobs (``repro_torch.api.measure`` only): ``reduced`` serves the
    CPU-sized reduced config, ``n_requests`` decouples offered traffic from
    ``batch`` slots, ``decode_block``/``temperature``/``seed`` mirror
    ``EngineConfig``.
    """
    model: Union[str, ArchConfig]
    variant: Union[str, Variant] = "bf16-bf16"
    batch: int = 1
    prompt_len: int = 512
    gen_len: int = 128
    chunk: Optional[int] = None
    past_lens: Optional[Sequence[int]] = None
    lora_rank: Optional[int] = None
    # prefix-reuse traffic shape (paper's "local agent" scenario)
    shared_prefix_len: Optional[int] = None
    block_size: Optional[int] = None
    prefix_cache: bool = True
    attn_impl: Optional[str] = None
    # sharding (tensor-parallel × pipeline-parallel; 1×1 = single chip)
    tp: int = 1
    pp: int = 1
    # speculative decoding: k drafts/step, assumed per-draft acceptance α
    # (forecast side; the measured side records realized acceptance), and
    # an optional small draft architecture (None = free n-gram drafter)
    spec_k: int = 0
    spec_acceptance: float = 0.7
    spec_draft_arch: Optional[str] = None
    # measured prompts repeat a motif of this many tokens instead of being
    # i.i.d. random — a high-acceptance workload (agent loops, templated
    # traffic) the n-gram drafter locks onto
    prompt_motif_len: Optional[int] = None
    # measured-path traffic shape
    reduced: bool = False
    n_requests: Optional[int] = None
    gen_lens: Optional[Sequence[int]] = None
    decode_block: int = 8
    temperature: float = 0.0
    seed: int = 0
    # stochastic traffic (repro_torch.traffic): arrival process + SLO pair.
    # ``arrival`` turns the scenario into an open-loop served stream —
    # forecast and measure both consume the same seeded TrafficTrace and
    # report p50/p90/p99 TTFT/TPOT plus goodput under (ttft_slo, tpot_slo)
    arrival: Optional[str] = None
    qps: float = 0.0
    ttft_slo: Optional[float] = None
    tpot_slo: Optional[float] = None
    trace_file: Optional[str] = None
    prompt_len_dist: Optional[str] = None
    gen_len_dist: Optional[str] = None
    # bucketed prefill-and-insert: admit up to this many same-bucket
    # requests in ONE batched prefill dispatch (1 = sequential admission)
    prefill_batch: int = 1
    # multi-tenant LoRA serving: ``lora_n_tenants`` tenants cycling
    # through ``lora_ranks`` (tenant t has rank ranks[t % len(ranks)]),
    # requests drawn from a Zipf(``lora_popularity``) tenant law
    # (0 = uniform).  The measured engine serves through the grouped-LoRA
    # pool; the forecast prices the per-slot rank mix of every step.
    # Distinct from ``lora_rank``, which merges ONE adapter into the
    # weights (Eq. 7) instead of serving many dynamically.
    lora_n_tenants: int = 0
    lora_ranks: Tuple[int, ...] = ()
    lora_popularity: float = 0.0

    def __post_init__(self):
        # fail fast on registry names (also catches stale names coming back
        # through from_dict) — object forms are already resolved
        if isinstance(self.model, str) and self.model not in configs.ARCHS:
            raise KeyError(f"unknown arch {self.model!r}; known: "
                           f"{sorted(configs.ARCHS)}")
        if (isinstance(self.variant, str)
                and self.variant not in PAPER_VARIANTS):
            raise KeyError(f"unknown variant {self.variant!r}; known: "
                           f"{sorted(PAPER_VARIANTS)}")
        if self.past_lens is not None:
            pls = tuple(int(p) for p in self.past_lens)
            if not pls or any(p < 0 for p in pls):
                raise ValueError("past_lens must be non-empty, >= 0 each")
            object.__setattr__(self, "past_lens", pls)
            object.__setattr__(self, "batch", len(pls))
        if self.gen_lens is not None:
            gls = tuple(int(g) for g in self.gen_lens)
            if not gls or any(g < 1 for g in gls):
                raise ValueError("gen_lens must be non-empty, >= 1 each")
            object.__setattr__(self, "gen_lens", gls)
            object.__setattr__(self, "n_requests", len(gls))
        if self.batch < 1 or self.prompt_len < 1 or self.gen_len < 1:
            raise ValueError("batch, prompt_len and gen_len must be >= 1")
        if self.chunk is not None and self.chunk < 1:
            raise ValueError("chunk must be >= 1")
        if self.shared_prefix_len is not None and not (
                0 <= self.shared_prefix_len <= self.prompt_len):
            raise ValueError("shared_prefix_len must be in [0, prompt_len]")
        if self.block_size is not None and self.block_size < 1:
            raise ValueError("block_size must be >= 1")
        from repro_torch.core.workload import ENGINE_ATTN_IMPLS
        if self.attn_impl not in ENGINE_ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of "
                             f"{ENGINE_ATTN_IMPLS}, got {self.attn_impl!r}")
        if self.tp < 1:
            raise ValueError(f"tp must be >= 1, got {self.tp}")
        if self.pp < 1:
            raise ValueError(f"pp must be >= 1, got {self.pp}")
        if self.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {self.spec_k}")
        if not 0.0 <= self.spec_acceptance <= 1.0:
            raise ValueError(f"spec_acceptance must be in [0, 1], got "
                             f"{self.spec_acceptance}")
        if (self.spec_draft_arch is not None
                and self.spec_draft_arch not in configs.ARCHS):
            raise KeyError(f"unknown draft arch {self.spec_draft_arch!r}; "
                           f"known: {sorted(configs.ARCHS)}")
        if self.prompt_motif_len is not None and not (
                1 <= self.prompt_motif_len <= self.prompt_len):
            raise ValueError("prompt_motif_len must be in [1, prompt_len]")
        if self.prefill_batch < 1:
            raise ValueError(f"prefill_batch must be >= 1, "
                             f"got {self.prefill_batch}")
        if self.lora_n_tenants < 0:
            raise ValueError(f"lora_n_tenants must be >= 0, "
                             f"got {self.lora_n_tenants}")
        if self.lora_n_tenants > 0:
            ranks = tuple(int(r) for r in self.lora_ranks) or (8,)
            if min(ranks) < 1:
                raise ValueError(f"lora_ranks must be >= 1 each, "
                                 f"got {ranks}")
            object.__setattr__(self, "lora_ranks", ranks)
        elif self.lora_ranks:
            raise ValueError("lora_ranks requires lora_n_tenants > 0")
        else:
            # JSON roundtrips deserialize the empty default as a list
            object.__setattr__(self, "lora_ranks", ())
        if self.lora_popularity < 0:
            raise ValueError(f"lora_popularity must be >= 0, "
                             f"got {self.lora_popularity}")
        from repro_torch.traffic import ARRIVAL_KINDS, LengthDist
        if self.arrival is not None:
            known = ARRIVAL_KINDS + ("replay",)
            if self.arrival not in known:
                raise ValueError(f"arrival must be one of {known}, "
                                 f"got {self.arrival!r}")
            if self.arrival == "replay":
                if not self.trace_file:
                    raise ValueError(
                        "arrival='replay' requires trace_file")
            elif not self.qps > 0:
                raise ValueError(f"qps must be > 0 for arrival="
                                 f"{self.arrival!r}, got {self.qps}")
            if self.spec_k > 0:
                raise ValueError("traffic scenarios do not compose with "
                                 "spec_k > 0 yet (speculative admission "
                                 "is not modeled under queueing)")
        elif self.trace_file:
            object.__setattr__(self, "arrival", "replay")
        if self.ttft_slo is not None and not self.ttft_slo > 0:
            raise ValueError(f"ttft_slo must be > 0, got {self.ttft_slo}")
        if self.tpot_slo is not None and not self.tpot_slo > 0:
            raise ValueError(f"tpot_slo must be > 0, got {self.tpot_slo}")
        for name in ("prompt_len_dist", "gen_len_dist"):
            spec = getattr(self, name)
            if spec is not None:
                LengthDist.parse(spec)    # raises ValueError on bad spec

    # ------------------------------------------------------------------
    # resolution
    # ------------------------------------------------------------------
    @property
    def arch(self) -> ArchConfig:
        """The architecture this scenario runs (honors ``reduced``)."""
        cfg = (configs.get(self.model) if isinstance(self.model, str)
               else self.model)
        return configs.reduced(cfg) if self.reduced else cfg

    @property
    def variant_obj(self) -> Variant:
        v = (PAPER_VARIANTS[self.variant] if isinstance(self.variant, str)
             else self.variant)
        if self.lora_rank is not None:
            v = dataclasses.replace(v, lora_rank=self.lora_rank)
        return v

    @property
    def model_name(self) -> str:
        return self.model if isinstance(self.model, str) else self.model.name

    @property
    def variant_name(self) -> str:
        return (self.variant if isinstance(self.variant, str)
                else self.variant.name)

    @property
    def plan(self) -> "ShardingPlan":
        """The scenario's sharding plan (MoE expert parallelism rides the
        same model axis as tp, like the engine's mesh)."""
        from repro_torch.core.workload import ShardingPlan
        ep = self.tp if self.arch.family == "moe" else 1
        return ShardingPlan(tp=self.tp, ep=ep, pp=self.pp)

    @property
    def decode_past_lens(self) -> Tuple[int, ...]:
        """Per-slot KV lengths of the decode step being forecast."""
        if self.past_lens is not None:
            return self.past_lens
        return (self.prompt_len,) * self.batch

    @property
    def request_gen_lens(self) -> Tuple[int, ...]:
        """Per-request generation budgets for the measured path."""
        if self.gen_lens is not None:
            return self.gen_lens
        return (self.gen_len,) * (self.n_requests or self.batch)

    @property
    def engine_block_size(self) -> int:
        """KV block size the engine/analytical sides agree on."""
        if self.block_size is not None:
            return self.block_size
        from repro_torch.core.workload import DEFAULT_KV_BLOCK_SIZE
        return DEFAULT_KV_BLOCK_SIZE

    @property
    def has_traffic(self) -> bool:
        """True when the scenario describes a served arrival stream."""
        return self.arrival is not None

    def traffic(self, arrival: str = "poisson", qps: float = 1.0, *,
                ttft_slo: Optional[float] = None,
                tpot_slo: Optional[float] = None,
                trace_file: Optional[str] = None,
                prompt_len_dist: Optional[str] = None,
                gen_len_dist: Optional[str] = None,
                prefill_batch: Optional[int] = None) -> "Scenario":
        """This scenario served as an open-loop arrival stream.

        ``arrival`` ∈ ``{"deterministic", "poisson", "bursty", "replay"}``
        at ``qps`` requests/s (ignored for ``"replay"``, which loads
        ``trace_file`` instead).  Lengths default to the scenario's
        ``prompt_len``/``gen_len`` constants unless a distribution spec
        (``"uniform:16:64"``, ``"lognormal:32:0.5"``) is given.  The SLO
        pair feeds goodput; a missing bound is unbounded.
        """
        return dataclasses.replace(
            self, arrival=arrival, qps=qps, ttft_slo=ttft_slo,
            tpot_slo=tpot_slo, trace_file=trace_file,
            prompt_len_dist=prompt_len_dist, gen_len_dist=gen_len_dist,
            prefill_batch=(self.prefill_batch if prefill_batch is None
                           else prefill_batch))

    @classmethod
    def lora_tenants(cls, n: int, ranks: Sequence[int],
                     popularity: float = 0.0, *,
                     model: Union[str, ArchConfig] = "llama2-7b",
                     **kw) -> "Scenario":
        """A multi-tenant LoRA serving scenario: ``n`` tenants whose
        adapter ranks cycle through ``ranks``, requests drawn from a
        Zipf(``popularity``) tenant distribution (0 = uniform)."""
        return cls(model=model, lora_n_tenants=int(n),
                   lora_ranks=tuple(int(r) for r in ranks),
                   lora_popularity=popularity, **kw)

    @property
    def has_lora_tenants(self) -> bool:
        return self.lora_n_tenants > 0

    def lora_rank_of(self, adapter_id: int) -> int:
        """Adapter rank of one tenant (same cycling as AdapterStore)."""
        if not self.lora_ranks:
            return 0
        return self.lora_ranks[adapter_id % len(self.lora_ranks)]

    def lora_adapter_ids(self, count: int) -> Tuple[int, ...]:
        """Seeded per-request tenant assignment (measured AND forecast
        paths sample the same stream)."""
        if not self.has_lora_tenants:
            return ()
        return zipf_adapter_ids(self.lora_n_tenants, count,
                                self.lora_popularity, self.seed)

    @property
    def lora_decode_mix(self) -> Tuple[int, ...]:
        """Per-slot adapter ranks of the decode step being forecast."""
        if not self.has_lora_tenants:
            return ()
        return tuple(self.lora_rank_of(a)
                     for a in self.lora_adapter_ids(self.batch))

    def spec_decode(self, k: int, acceptance: float = 0.7,
                    draft_arch: Optional[str] = None) -> "Scenario":
        """This scenario with speculative decoding: ``k`` drafts verified
        per step at assumed per-draft acceptance ``acceptance`` (the
        forecast's α — the measured engine records the realized rate),
        optionally drafted by a small ``draft_arch`` instead of the free
        self-speculative n-gram drafter."""
        return dataclasses.replace(self, spec_k=k,
                                   spec_acceptance=acceptance,
                                   spec_draft_arch=draft_arch)

    @property
    def cached_prefix_len(self) -> int:
        """Prompt tokens a warm admission maps from shared blocks.

        The radix index shares full blocks only, and at least one prompt
        token must be computed to produce first-token logits — the same
        capping the engine applies (``Engine._allocate``).
        """
        if not self.prefix_cache or not self.shared_prefix_len:
            return 0
        bs = self.engine_block_size
        return min((self.shared_prefix_len // bs) * bs, self.prompt_len - 1)

    # ------------------------------------------------------------------
    # serialization (JSON round-trip for registry-named scenarios)
    # ------------------------------------------------------------------
    def to_dict(self) -> dict:
        d = {
            "model": self.model_name,
            "variant": self.variant_name,
            "batch": self.batch,
            "prompt_len": self.prompt_len,
            "gen_len": self.gen_len,
            "chunk": self.chunk,
            "past_lens": list(self.past_lens) if self.past_lens else None,
            "lora_rank": self.lora_rank,
            "shared_prefix_len": self.shared_prefix_len,
            "block_size": self.block_size,
            "prefix_cache": self.prefix_cache,
            "attn_impl": self.attn_impl,
            "tp": self.tp,
            "pp": self.pp,
            "spec_k": self.spec_k,
            "spec_acceptance": self.spec_acceptance,
            "spec_draft_arch": self.spec_draft_arch,
            "prompt_motif_len": self.prompt_motif_len,
            "reduced": self.reduced,
            "n_requests": self.n_requests,
            "gen_lens": list(self.gen_lens) if self.gen_lens else None,
            "decode_block": self.decode_block,
            "temperature": self.temperature,
            "seed": self.seed,
            "arrival": self.arrival,
            "qps": self.qps,
            "ttft_slo": self.ttft_slo,
            "tpot_slo": self.tpot_slo,
            "trace_file": self.trace_file,
            "prompt_len_dist": self.prompt_len_dist,
            "gen_len_dist": self.gen_len_dist,
            "prefill_batch": self.prefill_batch,
            "lora_n_tenants": self.lora_n_tenants,
            "lora_ranks": list(self.lora_ranks),
            "lora_popularity": self.lora_popularity,
        }
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Scenario":
        return cls(**{k: d[k] for k in (
            "model", "variant", "batch", "prompt_len", "gen_len", "chunk",
            "past_lens", "lora_rank", "shared_prefix_len", "block_size",
            "prefix_cache", "attn_impl", "tp", "pp", "spec_k",
            "spec_acceptance",
            "spec_draft_arch", "prompt_motif_len", "reduced", "n_requests",
            "gen_lens", "decode_block", "temperature", "seed", "arrival",
            "qps", "ttft_slo", "tpot_slo", "trace_file", "prompt_len_dist",
            "gen_len_dist", "prefill_batch", "lora_n_tenants",
            "lora_ranks", "lora_popularity") if k in d})
