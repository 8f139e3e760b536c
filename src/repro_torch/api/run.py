"""Scenario→Report runners: the analytical and measured pipelines.

``forecast``  — paper Eqs. 1–6 on a :class:`~repro_torch.core.hardware.HardwareSpec`
                (pure analytical; runs anywhere in milliseconds).
``measure``   — the port's continuous-batching engine on the card (or the
                CPU when asked), returning the SAME Report schema.
``sweep``     — ``forecast`` across a hardware list or a TOPS×BW grid.

Both runners share the Scenario resolution and the analytical phase
workload, so a forecast and a measurement of the same Scenario are
directly :func:`repro_torch.api.compare`-able.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Union

from repro_torch.core import hardware
from repro_torch.core.forecast import Forecaster
from repro_torch.core.hardware import HardwareSpec
from repro_torch.core.stats import Totals
from repro_torch.core.workload import WorkloadModel

from .report import PhaseStats, Report
from .scenario import Scenario

HardwareLike = Union[str, HardwareSpec]


def _workload_model(scn: Scenario) -> WorkloadModel:
    """The scenario's analytical twin (attn-impl pricing + sharding plan).

    With ``scn.tp > 1`` every phase the model emits is the PER-CHIP
    workload (operator ops/bytes divided, collective wire recorded)."""
    return WorkloadModel(scn.arch, scn.variant_obj, attn_impl=scn.attn_impl,
                         plan=scn.plan)


def _prefill_db(wm: WorkloadModel, scn: Scenario):
    """The scenario's prefill StatsDB (shared by the aggregate phase
    totals and the pipeline-parallel per-stage split)."""
    table_bs = scn.engine_block_size if scn.attn_impl else None
    if table_bs:
        # prefill_cached(cached=0) == prefill/chunked_prefill + table reads
        return wm.prefill_cached(scn.batch, scn.prompt_len, 0,
                                 chunk=scn.chunk, block_size=table_bs)
    if scn.chunk:
        return wm.chunked_prefill(scn.batch, scn.prompt_len, scn.chunk)
    return wm.prefill(scn.batch, scn.prompt_len)


def _phase_totals(wm: WorkloadModel, scn: Scenario) -> Dict[str, Totals]:
    """Hardware-agnostic workload of the scenario's phases (Fig. 2-F).

    When the scenario pins an engine attention impl, the block-table id
    reads of addressing the paged cache are priced into every phase (the
    remat / fusion deltas of the impl itself live inside ``wm``).
    """
    table_bs = scn.engine_block_size if scn.attn_impl else None
    pre_db = _prefill_db(wm, scn)
    out = {"prefill": pre_db.totals("prefill")}
    if scn.shared_prefix_len is not None:
        # prefix-reuse regime (block-paged cache): one warm admission's
        # cache-miss suffix, batch 1 like the engine's per-request prefill
        warm = wm.prefill_cached(1, scn.prompt_len, scn.cached_prefix_len,
                                 chunk=scn.chunk,
                                 block_size=scn.engine_block_size)
        out["prefill_warm"] = warm.totals("prefill")
    pls = scn.decode_past_lens
    if len(set(pls)) == 1:
        # uniform batch: take the paper's direct path so forecasts match the
        # legacy Forecaster.tpot wiring bit-for-bit (tested)
        out["decode"] = wm.decode_step(len(pls), pls[0]).totals("decode")
    else:
        out["decode"] = wm.decode_totals_mixed(pls)
    if table_bs:
        for p in pls:
            out["decode"] = out["decode"].plus(
                wm.block_table_totals(1, p + 1, table_bs))
    if scn.lora_rank is not None:
        out["lora_update"] = wm.lora_update().totals("lora_update")
    if scn.spec_k:
        # one (k+1)-query speculative verify pass over the decode batch
        # (weight reads amortize across the queries), plus — with a draft
        # arch — ONE draft decode step (the spec step runs k of them)
        vt = wm.verify_totals_mixed(pls, scn.spec_k)
        if table_bs:
            for p in pls:
                vt = vt.plus(wm.block_table_totals(
                    1, p + scn.spec_k + 1, table_bs))
        out["spec_verify"] = vt
        if scn.spec_draft_arch:
            from repro_torch import configs
            draft_wm = WorkloadModel(configs.get(scn.spec_draft_arch))
            out["spec_draft"] = draft_wm.decode_totals_mixed(pls)
    if scn.has_lora_tenants:
        # multi-tenant grouped LoRA: every phase's dispatches carry the
        # per-slot adapter mix, priced at the pool-padded rank (both
        # executable impls compute/DMA the padded lanes)
        mix = list(scn.lora_decode_mix)
        R = max(scn.lora_ranks)
        step = wm.lora_step(mix, max_rank=R).totals("lora_step")
        out["lora_step"] = step
        out["decode"] = out["decode"].plus(step)
        out["prefill"] = out["prefill"].plus(
            wm.lora_step(mix, q_len=scn.prompt_len,
                         max_rank=R).totals("lora_step"))
        if "spec_verify" in out:
            out["spec_verify"] = out["spec_verify"].plus(
                wm.lora_step(mix, q_len=scn.spec_k + 1,
                             max_rank=R).totals("lora_step"))
    return out


def _phase_stats(totals: Dict[str, Totals]) -> Dict[str, PhaseStats]:
    return {k: PhaseStats.from_totals(t) for k, t in totals.items()}


# ----------------------------------------------------------------------
# stochastic traffic (repro_torch.traffic): both runners consume ONE trace
# ----------------------------------------------------------------------
def _traffic_trace(scn: Scenario):
    """The scenario's seeded :class:`~repro_torch.traffic.TrafficTrace`.

    ``arrival="replay"`` loads ``scn.trace_file``; generated processes
    draw lengths from the scenario's dist specs (falling back to its
    constant ``prompt_len``/``gen_len``).  Deterministic in the scenario.
    """
    from repro_torch.traffic import TrafficTrace, make_trace
    if scn.arrival == "replay":
        return TrafficTrace.load(scn.trace_file)
    return make_trace(
        scn.arrival, scn.qps, scn.n_requests or 16,
        prompt_lens=scn.prompt_len_dist or scn.prompt_len,
        gen_lens=scn.gen_len_dist or scn.gen_len,
        seed=scn.seed)


def _traffic_chunk(scn: Scenario, trace) -> int:
    """Chunked-prefill size both runners use for this trace."""
    return scn.chunk or max(r.prompt_len for r in trace.requests)


def _traffic_twin(scn: Scenario, spec: HardwareSpec, *, ec: float,
                  em: float, decode_ec: Optional[float]):
    """The ForecastTwin the traffic simulator prices steps with (same
    construction as the trace-replay path, minus AUTO: there is no
    engine header to resolve from)."""
    from repro_torch.engine.forecast_twin import ForecastTwin
    twin_bs = (scn.engine_block_size
               if (scn.block_size is not None
                   or scn.shared_prefix_len is not None
                   or scn.attn_impl is not None) else None)
    return ForecastTwin(scn.arch, spec, scn.variant_obj, ec=decode_ec,
                        em=em, prefill_ec=ec, prefill_em=em,
                        block_size=twin_bs, attn_impl=scn.attn_impl,
                        plan=scn.plan,
                        lora_mix=scn.lora_decode_mix,
                        lora_max_rank=max(scn.lora_ranks, default=0))


def _traffic_forecast(scn: Scenario, spec: HardwareSpec,
                      extras: Dict[str, object], *, ec: float, em: float,
                      decode_ec: Optional[float], twin=None):
    """Simulate serving ``scn``'s traffic analytically; fill
    ``extras["traffic"]`` and return the headline (ttft, tpot, tps)."""
    from repro_torch.traffic import TrafficStats, simulate_traffic
    trace = _traffic_trace(scn)
    if twin is None:
        twin = _traffic_twin(scn, spec, ec=ec, em=em, decode_ec=decode_ec)
    sim = simulate_traffic(
        twin, trace, max_slots=scn.batch,
        chunk_size=_traffic_chunk(scn, trace),
        decode_block=scn.decode_block,
        prefill_batch=scn.prefill_batch,
        cached_len=scn.cached_prefix_len)
    stats = TrafficStats.from_timings(
        sim.timings(), ttft_slo=scn.ttft_slo, tpot_slo=scn.tpot_slo,
        queue_depth=sim.queue_depth)
    extras["traffic"] = dict(
        stats.to_dict(), arrival=trace.arrival, qps=trace.qps,
        offered_qps=trace.offered_qps, prefill_batch=scn.prefill_batch)
    return stats.ttft["mean"], stats.tpot["mean"], stats.tps


def forecast(scenario: Scenario, hw: HardwareLike, *,
             ec: float = 1.0, em: float = 1.0,
             decode_ec: Optional[float] = None,
             include_dispatch: bool = True,
             trace: Optional[Sequence] = None) -> Report:
    """Analytical forecast of ``scenario`` on ``hw`` (paper Eqs. 1–6).

    ``ec``/``em`` are the prefill compute/memory operating efficiencies;
    decode is memory-bound per the paper (pass ``decode_ec`` to add the
    compute term as ``max(t_c, t_m)`` on very fast-memory hardware).
    ``include_dispatch`` drops the per-kernel dispatch term from TTFT
    (Table 6 convention).

    ``trace`` replays a measured engine scheduler trace (e.g.
    ``measure(...).trace``) through the analytical twin instead of the
    uniform model — TTFT/TPOT/TPS then reflect the exact admission order,
    slot reuse and mixed KV lengths the engine executed.  The knobs keep
    one meaning either way: ``ec``/``em`` scale the prefill chunks and
    ``em`` the decode steps of the replay just as they scale the uniform
    phases.  ``phases`` and the ``*_bound`` verdicts always characterize
    the declared (uniform) scenario, and ``include_dispatch`` only affects
    that uniform TTFT — the replay prices every dispatch, like the engine
    it mirrors.
    """
    spec = hardware.get(hw)
    arch, variant = scenario.arch, scenario.variant_obj
    wm = _workload_model(scenario)
    fc = Forecaster(spec)
    totals = _phase_totals(wm, scenario)

    pre = fc.phase(totals["prefill"], ec=ec, em=em,
                   include_dispatch=include_dispatch)
    dec = totals["decode"]
    tpot = fc.step_latency(dec, em=em, ec=decode_ec)
    # classify the decode step even when the compute term isn't added
    dec_tc = dec.ops / ((decode_ec or 1.0) * spec.flops)
    dec_tm = dec.mem_total / (em * spec.bw)
    dec_tx = fc.collective_time(dec)

    extras: Dict[str, object] = {}
    if scenario.pp > 1:
        # pipeline-parallel forecast: the per-layer workload is partitioned
        # into pp stages (stage-boundary activation hops priced as wire in
        # the records above).  TTFT pipelines the prefill's chunk
        # microbatches GPipe-style — bubble fraction (pp-1)/(m+pp-1) —
        # and decode's steady-state TPOT is paced by the slowest stage
        # (every stage is busy with a different in-flight token).
        pls = scenario.decode_past_lens
        m = (-(-scenario.prompt_len // scenario.chunk)
             if scenario.chunk else 1)
        pre_stages = wm.stage_totals(_prefill_db(wm, scenario), "prefill")
        pre = fc.pipeline_phase(pre_stages, m, ec=ec, em=em,
                                include_dispatch=include_dispatch)
        dec_stages = wm.decode_stage_totals_mixed(pls)
        table_bs = scenario.engine_block_size if scenario.attn_impl else None
        if table_bs:
            # block-table id reads belong to the attention layers; split
            # them over stages by each stage's share of attn layers
            kinds = arch.block_kinds()
            shares = [sum(1 for k in kinds[lo:hi] if k == "attn")
                      for lo, hi in wm.stage_spans()]
            n_attn = sum(shares) or 1
            bt = Totals()
            for p in pls:
                bt = bt.plus(wm.block_table_totals(1, p + 1, table_bs))
            dec_stages = [s.plus(bt, factor=share / n_attn)
                          for s, share in zip(dec_stages, shares)]
        tpot = fc.pipeline_step_latency(dec_stages, em=em, ec=decode_ec)
        extras.update(
            pp=scenario.pp,
            pp_microbatches=m,
            pp_bubble_fraction=fc.pipeline_bubble_fraction(scenario.pp, m),
            pp_hop_wire_bytes_per_step=((scenario.pp - 1)
                                        * wm.hop_wire_bytes(len(pls))),
            pp_decode_stage_s=[fc.step_latency(t, em=em, ec=decode_ec)
                               for t in dec_stages],
            interconnect_GBps=spec.interconnect_GBps)
    if scenario.tp > 1:
        # per-chip sharded forecast: surface the collective economics
        extras.update(
            tp=scenario.tp,
            interconnect_GBps=spec.interconnect_GBps,
            prefill_collective_s=pre.t_collective,
            decode_collective_s=dec_tx,
            decode_collective_frac=dec_tx / max(tpot, 1e-30))
    if scenario.spec_k:
        # speculative decoding forecast: the headline TPOT/TPS become the
        # expected per-token cost at the assumed acceptance α; the plain
        # step stays available as the speedup baseline, and break-even α
        # is a per-hardware quantity (both step latencies move with hw)
        k, alpha = scenario.spec_k, scenario.spec_acceptance
        vt = totals["spec_verify"]
        dt = totals.get("spec_draft")
        spec_tpot = fc.spec_tpot(vt, k, alpha, draft_totals=dt,
                                 em=em, ec=decode_ec)
        extras.update(
            spec_k=k, spec_acceptance=alpha,
            spec_expected_tokens_per_step=fc.spec_expected_tokens(k, alpha),
            spec_step_s=fc.spec_step_latency(vt, k, draft_totals=dt,
                                             em=em, ec=decode_ec),
            spec_tpot_s=spec_tpot,
            spec_speedup=tpot / spec_tpot,
            spec_breakeven_acceptance=fc.spec_breakeven_acceptance(
                dec, vt, k, draft_totals=dt, em=em, ec=decode_ec),
            spec_speedup_curve=fc.spec_speedup_curve(
                dec, vt, k, [i / 10.0 for i in range(11)],
                draft_totals=dt, em=em, ec=decode_ec))
        tpot = spec_tpot
    if "lora_update" in totals:
        extras["lora_update_s"] = fc.phase(totals["lora_update"],
                                           ec=ec, em=em).latency
    if scenario.has_lora_tenants:
        # per-tenant-mix adapter economics of one decode step
        mix = scenario.lora_decode_mix
        hist: Dict[int, int] = {}
        for r in mix:
            hist[r] = hist.get(r, 0) + 1
        lt = totals["lora_step"]
        extras["lora"] = dict(
            n_tenants=scenario.lora_n_tenants,
            ranks=list(scenario.lora_ranks),
            popularity=scenario.lora_popularity,
            pool_rank=max(scenario.lora_ranks),
            decode_mix={str(r): n for r, n in sorted(hist.items())},
            step_flops=lt.ops, step_bytes=lt.mem_total,
            step_s=fc.step_latency(lt, em=em, ec=decode_ec),
            step_frac=(fc.step_latency(lt, em=em, ec=decode_ec)
                       / max(tpot, 1e-30)))
    if scenario.shared_prefix_len is not None:
        # per-admission TTFT physics of the prefix-reuse regime: the first
        # request prefills the full prompt cold (batch 1, like the engine
        # admits), warm requests only their cache-miss suffix
        wm_cold = wm.prefill_cached(1, scenario.prompt_len, 0,
                                    chunk=scenario.chunk,
                                    block_size=scenario.engine_block_size)
        ttft_cold = fc.phase(wm_cold.totals("prefill"), ec=ec, em=em,
                             include_dispatch=include_dispatch).latency
        ttft_warm = fc.phase(totals["prefill_warm"], ec=ec, em=em,
                             include_dispatch=include_dispatch).latency
        n = scenario.n_requests or scenario.batch
        cached = scenario.cached_prefix_len
        extras.update(
            ttft_cold_s=ttft_cold, ttft_warm_s=ttft_warm,
            ttft_savings_s=ttft_cold - ttft_warm,
            cached_tokens=cached,
            prefix_hit_rate=(cached * (n - 1))
                            / (scenario.prompt_len * n),
            # what the engine charges: prompt plus all but the final
            # sampled token (Engine._blocks_needed)
            blocks_per_request=-(-(scenario.prompt_len + scenario.gen_len
                                   - 1) // scenario.engine_block_size),
            shared_blocks=cached // scenario.engine_block_size,
            block_size=scenario.engine_block_size)
    if trace is not None:
        # lazy import: the twin pulls the engine (and with it torch), which
        # the pure analytical path must not require
        from repro_torch.engine.forecast_twin import AUTO, ForecastTwin
        # block-paged scenarios price table reads in the replay too, so the
        # trace and declarative paths apply one physics; plain scenarios
        # leave both knobs AUTO, so the trace's "engine" header decides
        # what to price (a headerless hand-built trace prices neither,
        # bit-for-bit as before impl pricing existed, tested)
        twin_bs = (scenario.engine_block_size
                   if (scenario.block_size is not None
                       or scenario.shared_prefix_len is not None
                       or scenario.attn_impl is not None) else None)
        twin = ForecastTwin(arch, spec, variant, ec=decode_ec, em=em,
                            prefill_ec=ec, prefill_em=em,
                            block_size=twin_bs,
                            attn_impl=(scenario.attn_impl
                                       if scenario.attn_impl is not None
                                       else AUTO),
                            plan=scenario.plan,
                            draft_arch=scenario.spec_draft_arch,
                            lora_mix=scenario.lora_decode_mix,
                            lora_max_rank=max(scenario.lora_ranks,
                                              default=0))
        tf = twin.replay(trace)
        ttft_s, tpot_s, tps = tf.mean_ttft, tf.mean_tpot, tf.tps
        extras["trace_total_time_s"] = tf.total_time
        extras["trace_total_tokens"] = tf.total_tokens
        spec_events = [ev for ev in trace if ev.kind == "spec_step"]
        if spec_events:
            # measured-acceptance replay: the per-step accepted counts in
            # the trace drive the forecast, vs. the declared scenario's
            # assumed α above; the despeculated twin prices the same
            # token schedule without speculation (speedup grounding)
            from repro_torch.engine.forecast_twin import despeculate_trace
            n_prop = sum(sum(ev.proposed) for ev in spec_events)
            n_acc = sum(sum(ev.accepted) for ev in spec_events)
            slot_steps = sum(len(ev.slots) for ev in spec_events)
            plain = twin.replay(despeculate_trace(trace))
            extras.update(
                trace_spec_acceptance=n_acc / max(n_prop, 1),
                trace_spec_tokens_per_step=(
                    n_acc / max(slot_steps, 1) + 1.0),
                trace_spec_speedup=(plain.total_time
                                    / max(tf.total_time, 1e-30)))
        if tf.cached_tokens:
            # hit-aware replay: quantify what prefix caching bought by
            # re-pricing the same schedule cache-cold
            from repro_torch.engine.forecast_twin import cold_trace
            cold = twin.replay(cold_trace(trace))
            extras["trace_prefix_hit_rate"] = tf.prefix_hit_rate
            extras["trace_cached_tokens"] = tf.cached_tokens
            extras["trace_ttft_savings_s"] = (cold.mean_ttft - tf.mean_ttft)
            extras["trace_prefill_savings_s"] = (cold.prefill_time
                                                 - tf.prefill_time)
    elif scenario.has_traffic:
        # open-loop traffic: simulate the served queue analytically; the
        # headline metrics become the simulated stream's means and the
        # SLO summary (percentiles, goodput) lands in extras["traffic"]
        ttft_s, tpot_s, tps = _traffic_forecast(
            scenario, spec, extras, ec=ec, em=em, decode_ec=decode_ec)
    else:
        ttft_s, tpot_s = pre.latency, tpot
        tps = scenario.batch / tpot
        if scenario.shared_prefix_len is not None:
            # mean admission TTFT over 1 cold + (n-1) warm requests
            n = scenario.n_requests or scenario.batch
            ttft_s = (extras["ttft_cold_s"]
                      + (n - 1) * extras["ttft_warm_s"]) / n

    return Report(
        source="forecast", model=arch.name, variant=variant.name,
        hardware=spec.name, ttft_s=ttft_s, tpot_s=tpot_s, tps=tps,
        ttft_bound=pre.bound,
        tpot_bound=("collective" if dec_tx > max(dec_tc, dec_tm)
                    else "compute" if dec_tc > dec_tm else "memory"),
        ec=ec, em=em, phases=_phase_stats(totals),
        scenario=scenario.to_dict(), extras=extras,
        trace=tuple(trace) if trace is not None else None)


def _check_measurable(scenario: Scenario, dev, share_device: bool) -> None:
    """Refuse a sharded scenario with too few cards for its ranks (the
    reference's refusal) unless the caller lets the ranks share one."""
    tp, pp = scenario.tp, scenario.pp
    if tp * pp == 1:
        return
    if dev.type == "cuda":
        import torch
        n = torch.cuda.device_count()
        if tp * pp > n and not share_device:
            raise ValueError(
                f"Scenario tp={tp} × pp={pp} needs {tp * pp} devices but "
                f"only {n} are visible — pass share_device=True to run the "
                f"ranks on the visible cards over gloo, or run on a "
                f"{tp * pp}-card host")


def _measure_hw_name(hw: Optional[HardwareLike], dev) -> str:
    """The report's hardware label: ``hw`` if given, else the card the
    run happened on (``"host"`` for the CPU, as the reference labels its
    host-backend runs)."""
    if hw is not None:
        return hardware.get(hw).name
    if dev.type == "cuda":
        import torch
        return torch.cuda.get_device_name(dev)
    return "host"


def measure(scenario: Scenario, hw: Optional[HardwareLike] = None, *,
            device="cuda", share_device: bool = False) -> Report:
    """Run ``scenario`` on the port's engine and report measured metrics.

    The continuous-batching engine (block-paged KV cache, chunked-prefill
    admission, fused decode blocks) runs on ``device``: the card unless
    the caller passes ``device="cpu"``; without a GPU it raises (through
    :func:`repro_torch.resolve_device`) rather than fall back.  ``hw``
    only labels the report; the measured report's ``trace`` can be
    replayed via ``forecast(..., trace=...)`` for a same-schedule forecast
    on any target.

    Measured TTFT is admission → first token (queue-exclusive), like the
    forecast's (see ``repro_torch.engine.forecast_twin``).

    Families the engine does not serve (SSM, hybrid, MLA,
    encoder-decoder) run on the lockstep ``Server`` instead, timed in two
    legs as the reference times them: prefill plus the first token, then
    the remaining decode steps.  As in the reference, that branch passes
    no encoder frames, so an encoder-decoder's cross K/V stay zeros.

    The port's counterpart of the JAX package's ``measure``, with the same
    ``extras`` keys and ``mode`` values (``"engine"``,
    ``"engine-traffic"``, ``"legacy-lockstep"``) and the same KV-dtype
    mapping (int4 variants measure as int8).  Weights stay bf16 whatever
    ``dtype_w`` says, as in the reference.  Differences:

    * params come from the port's seeded ``init_params`` (a
      ``torch.Generator``) and prompts from
      ``np.random.default_rng(seed + 1)`` (a shared prefix from
      ``seed + 2``): the port cannot reproduce JAX's PRNG, so the same
      scenario serves other random weights and prompts than the
      reference's run;
    * ``tp·pp > 1`` starts ``tp·pp`` ranks (``repro_torch.launch.mesh``:
      one per card over NCCL, or with ``share_device=True`` all on the
      visible cards over gloo) and returns rank 0's report; each rank
      draws its shard of the one-device weights; the engine's families
      serve on the engine's mesh, the lockstep families on the
      ``Server``'s (``runtime.serve.make_serve_fns``).  MoE and VLM
      decoders run on the engine, a VLM as text, as in the reference;
    * temperature draws on the lockstep branch come from a
      ``torch.Generator`` seeded with ``seed``.
    """
    from repro_torch import resolve_device

    dev = resolve_device(device)
    _check_measurable(scenario, dev, share_device)
    if scenario.tp * scenario.pp > 1:
        from repro_torch.launch.mesh import spawn
        return spawn(_measure_rank, (scenario, hw), model=scenario.tp,
                     pipe=scenario.pp, device=dev,
                     share_device=share_device)[0]
    return _measure_on(scenario, hw, dev)


def _measure_rank(mesh, scenario: Scenario, hw: Optional[HardwareLike]
                  ) -> Optional[Report]:
    """One rank of a sharded :func:`measure`: every rank serves the same
    scenario on its shard; rank 0's report is the run's."""
    report = _measure_on(scenario, hw, mesh.device, mesh)
    return report if mesh.rank == 0 else None


def _measure_on(scenario: Scenario, hw: Optional[HardwareLike], dev,
                mesh=None) -> Report:
    """:func:`measure` on one device, or on this rank of ``mesh``."""
    import time

    import numpy as np

    from repro_torch.engine import (Engine, EngineConfig, Request,
                                    engine_supported)
    from repro_torch.models import init_params
    from repro_torch.runtime.sharding import init_shard

    arch, variant = scenario.arch, scenario.variant_obj
    hw_name = _measure_hw_name(hw, dev)
    totals = _phase_totals(_workload_model(scenario), scenario)
    # the engine stores KV in bf16 or int8; int4 variants measure as int8
    kv_dtype = "int8" if variant.kv_dtype.startswith("int") else "bf16"
    tp, pp = scenario.tp, scenario.pp
    params = (init_params(arch, scenario.seed, device=dev) if mesh is None
              else init_shard(arch, scenario.seed, mesh, device=dev))
    if scenario.has_traffic:
        if not engine_supported(arch):
            raise ValueError(f"traffic scenarios need an engine-supported "
                             f"family, not {arch.family!r}")
        return _measure_traffic(scenario, hw_name, arch, variant, totals,
                                kv_dtype, params, dev, mesh)
    gen_lens = scenario.request_gen_lens
    n_req = len(gen_lens)
    max_len = scenario.prompt_len + max(gen_lens) + max(8, scenario.decode_block)
    prompts = np.random.default_rng(scenario.seed + 1).integers(
        0, arch.vocab_size, (n_req, scenario.prompt_len))
    if scenario.shared_prefix_len:
        # common system prompt: every request opens with the same tokens
        shared = np.random.default_rng(scenario.seed + 2).integers(
            0, arch.vocab_size, (scenario.shared_prefix_len,))
        prompts[:, :scenario.shared_prefix_len] = shared[None, :]
    if scenario.prompt_motif_len:
        # repeat each request's leading motif across its whole prompt
        # (after the shared-prefix substitution, so a shared prefix is
        # itself motif-periodic)
        reps = -(-scenario.prompt_len // scenario.prompt_motif_len)
        prompts = np.tile(prompts[:, :scenario.prompt_motif_len],
                          (1, reps))[:, :scenario.prompt_len]

    if not engine_supported(arch):
        return _measure_lockstep(scenario, hw_name, arch, variant, totals,
                                 kv_dtype, params, prompts, max_len, dev,
                                 mesh)
    extras: Dict[str, object] = {}
    ec = EngineConfig(max_slots=scenario.batch, max_len=max_len,
                      chunk_size=scenario.chunk or scenario.prompt_len,
                      decode_block=scenario.decode_block,
                      block_size=scenario.engine_block_size,
                      prefix_cache=scenario.prefix_cache,
                      kv_dtype=kv_dtype,
                      attn_impl=scenario.attn_impl or "gather",
                      temperature=scenario.temperature,
                      spec_k=scenario.spec_k,
                      lora_tenants=scenario.lora_n_tenants,
                      lora_ranks=scenario.lora_ranks,
                      seed=scenario.seed)
    aids = scenario.lora_adapter_ids(n_req)
    reqs = [Request(rid=i, prompt=prompts[i].tolist(),
                    max_new=gen_lens[i],
                    adapter_id=(aids[i] if aids else None))
            for i in range(n_req)]
    drafter = None
    if scenario.spec_k and scenario.spec_draft_arch:
        from repro_torch.engine.drafter import make_drafter
        # a reduced target needs a reduced (vocab-matched) draft model
        drafter = make_drafter(scenario.spec_draft_arch,
                               reduce=scenario.reduced,
                               vocab_size=(arch.vocab_size
                                           if scenario.reduced else None),
                               seed=scenario.seed, device=dev)
    eng = Engine(arch, params, ec, device=dev, drafter=drafter, mesh=mesh)
    eng.warmup()               # kernel builds stay outside the measured window
    # materialize host-side factors of every tenant the run will touch
    # (stand-in for checkpointed adapters already in host RAM) — the
    # device loads on pool misses stay measured
    for a in sorted({a for a in aids if a is not None}):
        eng.adapter_store.factors(a)
    t0 = time.perf_counter()
    results = eng.run(reqs)
    wall = time.perf_counter() - t0
    ttft_s = sum(r.ttft for r in results) / len(results)
    with_tpot = [r for r in results if len(r.tokens) > 1]
    tpot_s = (sum(r.tpot for r in with_tpot) / len(with_tpot)
              if with_tpot else 0.0)
    tps = eng.aggregate_tps()
    trace = tuple(eng.trace)
    extras.update(mode="engine", wall_s=wall,
                  tokens=sum(len(r.tokens) for r in results),
                  requests=n_req,
                  attn_impl=ec.attn_impl,
                  tp=tp,
                  pp=pp,
                  block_size=ec.block_size,
                  prefix_hit_tokens=eng.prefix_hit_tokens,
                  prefix_hit_rate=eng.prefix_hit_rate,
                  peak_blocks_in_use=eng.peak_blocks_in_use)
    if ec.lora_tenants:
        extras["lora"] = _lora_extras(scenario, ec, eng)
    if ec.spec_k:
        extras.update(spec_k=ec.spec_k,
                      spec_steps=eng.spec_steps,
                      spec_proposed=eng.spec_proposed,
                      spec_accepted=eng.spec_accepted,
                      spec_acceptance=eng.spec_acceptance,
                      spec_tokens_per_step=eng.spec_tokens_per_step)

    return Report(
        source="measured", model=arch.name, variant=variant.name,
        hardware=hw_name, ttft_s=ttft_s, tpot_s=tpot_s, tps=tps,
        phases=_phase_stats(totals), scenario=scenario.to_dict(),
        extras=extras, trace=trace)


def _measure_lockstep(scenario: Scenario, hw_name: str, arch, variant,
                      totals, kv_dtype: str, params, prompts, max_len: int,
                      dev, mesh=None) -> Report:
    """The reference's legacy lockstep branch: whole-batch generation on
    the ``Server`` (on this rank of ``mesh``, if given), timed in two legs
    (prefill plus the first token, then the remaining decode steps),
    after an untimed two-token warm-up."""
    import time

    import torch

    from repro_torch.engine.sampling import sample
    from repro_torch.runtime import ServeConfig, Server

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    gen_lens = scenario.request_gen_lens
    n_req = len(gen_lens)
    sc = ServeConfig(batch=n_req, max_len=max_len, chunk_size=scenario.chunk,
                     kv_dtype=kv_dtype, temperature=scenario.temperature)
    n_new = max(gen_lens)
    server = Server(arch, params, sc, device=dev, mesh=mesh)
    prompts = torch.as_tensor(prompts, device=dev)
    server.generate(prompts, 2)              # kernel builds, allocator
    sync()
    t0 = time.perf_counter()
    state = server.init_state()
    gen = torch.Generator(device=dev)
    gen.manual_seed(scenario.seed)
    chunk = sc.chunk_size or scenario.prompt_len
    logits = None
    for off in range(0, scenario.prompt_len, chunk):
        logits, state = server.prefill(state, prompts[:, off:off + chunk])
    tok = sample(logits, sc.temperature, gen)
    sync()
    ttft_s = time.perf_counter() - t0
    n_toks = n_req
    for _ in range(n_new - 1):
        logits, state = server.decode(state, tok[:, None])
        tok = sample(logits, sc.temperature, gen)
        n_toks += n_req
    sync()
    wall = time.perf_counter() - t0
    tpot_s = (wall - ttft_s) / max(n_new - 1, 1)
    extras = dict(mode="legacy-lockstep", wall_s=wall, tokens=n_toks,
                  requests=n_req)
    return Report(
        source="measured", model=arch.name, variant=variant.name,
        hardware=hw_name, ttft_s=ttft_s, tpot_s=tpot_s, tps=n_toks / wall,
        phases=_phase_stats(totals), scenario=scenario.to_dict(),
        extras=extras, trace=None)


def _lora_extras(scenario: Scenario, ec, eng) -> Dict[str, object]:
    return dict(
        n_tenants=ec.lora_tenants, ranks=list(ec.lora_ranks),
        popularity=scenario.lora_popularity,
        pool_slots=ec.adapter_pool_slots,
        hit_rate=eng.adapter_hit_rate,
        hits=eng.adapter_pool.hits,
        misses=eng.adapter_pool.misses,
        evictions=eng.adapter_pool.evictions)


def _measure_traffic(scenario: Scenario, hw_name: str, arch, variant,
                     totals, kv_dtype: str, params, dev, mesh=None
                     ) -> Report:
    """Serve the scenario's TrafficTrace open-loop on the port's engine.

    The trace's arrival seconds become ``Request.arrival_step`` gates via
    a calibrated wall-clock step period (measured post-warmup), so the
    engine sees the offered process at its own speed; per-request wall
    timings reduce to the same :class:`~repro_torch.traffic.TrafficStats`
    the analytical simulator reports — goodput is measured-vs-forecast
    comparable by construction.
    """
    import time

    from repro_torch.engine import Engine, EngineConfig, Request
    from repro_torch.traffic import (TrafficStats, arrival_steps,
                                     timings_from_results, trace_prompts)

    trace = _traffic_trace(scenario)
    chunk = _traffic_chunk(scenario, trace)
    max_len = (max(r.prompt_len + r.gen_len for r in trace.requests)
               + max(8, scenario.decode_block))
    ec = EngineConfig(max_slots=scenario.batch, max_len=max_len,
                      chunk_size=chunk,
                      decode_block=scenario.decode_block,
                      block_size=scenario.engine_block_size,
                      prefix_cache=scenario.prefix_cache,
                      kv_dtype=kv_dtype,
                      attn_impl=scenario.attn_impl or "gather",
                      temperature=scenario.temperature,
                      prefill_batch=scenario.prefill_batch,
                      lora_tenants=scenario.lora_n_tenants,
                      lora_ranks=scenario.lora_ranks,
                      seed=scenario.seed)
    prompts = trace_prompts(
        trace, arch.vocab_size, seed=scenario.seed + 1,
        shared_prefix_len=scenario.shared_prefix_len or 0)
    aids = scenario.lora_adapter_ids(trace.n_requests)
    eng = Engine(arch, params, ec, device=dev, mesh=mesh)
    eng.warmup()               # kernel builds stay outside the measured window
    for a in sorted({a for a in aids if a is not None}):
        eng.adapter_store.factors(a)   # host factors, like measure()
    period = eng.calibrate_step_period()
    if mesh is not None:
        import torch
        # one step clock for every rank, so every rank gates the same
        # arrivals at the same steps
        period = float(mesh.from_rank0(torch.tensor(
            [period], dtype=torch.float64, device=dev))[0])
    steps = arrival_steps(trace, period)
    reqs = [Request(rid=r.rid, prompt=list(map(int, p)),
                    max_new=r.gen_len, arrival_step=s,
                    adapter_id=(aids[i] if aids else None))
            for i, (r, p, s) in enumerate(
                zip(trace.requests, prompts, steps))]
    t0 = time.perf_counter()
    results = eng.run(reqs)
    wall = time.perf_counter() - t0
    stats = TrafficStats.from_timings(
        timings_from_results(results),
        ttft_slo=scenario.ttft_slo, tpot_slo=scenario.tpot_slo,
        queue_depth=[(t, d) for _, t, d in eng.queue_depth])
    extras: Dict[str, object] = dict(
        mode="engine-traffic", wall_s=wall, tokens=stats.total_tokens,
        requests=trace.n_requests, attn_impl=ec.attn_impl,
        block_size=ec.block_size, step_period_s=period,
        prefix_hit_tokens=eng.prefix_hit_tokens,
        prefix_hit_rate=eng.prefix_hit_rate,
        peak_blocks_in_use=eng.peak_blocks_in_use,
        traffic=dict(stats.to_dict(), arrival=trace.arrival,
                     qps=trace.qps, offered_qps=trace.offered_qps,
                     prefill_batch=scenario.prefill_batch))
    if ec.lora_tenants:
        extras["lora"] = _lora_extras(scenario, ec, eng)
    return Report(
        source="measured", model=arch.name, variant=variant.name,
        hardware=hw_name, ttft_s=stats.ttft["mean"],
        tpot_s=stats.tpot["mean"], tps=stats.tps,
        phases=_phase_stats(totals), scenario=scenario.to_dict(),
        extras=extras, trace=tuple(eng.trace))


def max_qps(scenario: Scenario, hw: HardwareLike, *,
            goodput_target: float = 0.99, qps_lo: float = 0.5,
            qps_hi: Optional[float] = None, rel_tol: float = 0.02,
            ec: float = 1.0, em: float = 1.0,
            decode_ec: Optional[float] = None) -> float:
    """Largest offered QPS whose FORECAST goodput meets the target.

    The capacity question of the paper's what-if loop: bisect the
    scenario's arrival process (same seed — probes are time-scalings of
    one request population, see ``repro_torch.traffic.arrivals``) against the
    analytical queue simulator on ``hw``.  Needs a generated traffic
    scenario (``Scenario.traffic(...)``) with at least one SLO bound.
    """
    from repro_torch.traffic import capacity_search
    if not scenario.has_traffic:
        raise ValueError("max_qps needs a traffic scenario — use "
                         "Scenario.traffic(...)")
    if scenario.arrival == "replay":
        raise ValueError("max_qps needs a generated arrival process; a "
                         "replay trace has a fixed offered rate")
    if scenario.ttft_slo is None and scenario.tpot_slo is None:
        raise ValueError("max_qps needs ttft_slo and/or tpot_slo")
    spec = hardware.get(hw)
    twin = _traffic_twin(scenario, spec, ec=ec, em=em, decode_ec=decode_ec)

    def goodput_at(qps: float) -> float:
        scn = dataclasses.replace(scenario, qps=qps)
        extras: Dict[str, object] = {}
        _traffic_forecast(scn, spec, extras, ec=ec, em=em,
                          decode_ec=decode_ec, twin=twin)
        return extras["traffic"]["goodput"]

    return capacity_search(goodput_at, target=goodput_target,
                           qps_lo=qps_lo, qps_hi=qps_hi, rel_tol=rel_tol)


def sweep(scenario: Scenario,
          hardware_list: Optional[Iterable[HardwareLike]] = None, *,
          tops: Optional[Sequence[float]] = None,
          bw: Optional[Sequence[float]] = None,
          interconnect_GBps: Optional[float] = None,
          tp_degrees: Optional[Sequence[int]] = None,
          pp_degrees: Optional[Sequence[int]] = None,
          ec: float = 1.0, em: float = 1.0,
          decode_ec: Optional[float] = None) -> List[Report]:
    """Forecast ``scenario`` across hardware targets (paper Fig. 5 style).

    Pass named/spec'd targets via ``hardware_list``, and/or a synthetic
    TOPS×BW grid via ``tops`` + ``bw`` (both in the paper's units: TOPS and
    GB/s); the grid cross-product is appended after the named targets.
    A sharded scenario (``tp > 1`` or ``pp > 1``) needs
    ``interconnect_GBps`` on every target — named specs carry their own,
    grid points take it from the ``interconnect_GBps`` argument (required
    in that case, so collective traffic is never silently priced against a
    zero-bandwidth wire).

    ``tp_degrees`` / ``pp_degrees`` sweep the scenario over a model-parallel
    plan grid as well: every (tp, pp) combination of the given degrees is
    forecast on every hardware target (scenario-major order — all targets
    of one plan are adjacent).  Left unset, each axis stays at the
    scenario's own degree, so plain hardware sweeps are unchanged.
    """
    scns = [scenario]
    if tp_degrees is not None or pp_degrees is not None:
        scns = [dataclasses.replace(scenario, tp=t, pp=p)
                for t in (tp_degrees if tp_degrees is not None
                          else (scenario.tp,))
                for p in (pp_degrees if pp_degrees is not None
                          else (scenario.pp,))]
    specs: List[HardwareSpec] = [hardware.get(h) for h in hardware_list or ()]
    if (tops is None) != (bw is None):
        raise ValueError("tops and bw must be given together")
    if tops is not None:
        sharded = [s for s in scns if s.tp > 1 or s.pp > 1]
        if sharded and interconnect_GBps is None:
            s = sharded[0]
            raise ValueError(
                f"a tops×bw grid sweep of a tp={s.tp}×pp={s.pp} scenario "
                f"needs interconnect_GBps for the synthetic targets")
        for t in tops:
            for b in bw:
                specs.append(HardwareSpec(
                    name=f"grid-{t:g}tops-{b:g}gbps", tops=float(t),
                    bw_gbps=float(b),
                    interconnect_GBps=interconnect_GBps or 0.0))
    if not specs:
        raise ValueError("sweep needs hardware_list and/or a tops×bw grid")
    return [forecast(scn, s, ec=ec, em=em, decode_ec=decode_ec)
            for scn in scns for s in specs]
