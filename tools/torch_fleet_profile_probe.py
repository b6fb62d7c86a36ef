"""Does a torch.profiler trace of a flash step keep every flash forward
record after the serving fleet's phases ran in the same process?

    python3 tools/torch_fleet_profile_probe.py      # on one CUDA card

Each probe builds chip_smoke's dygraph BERT-base (b16, T 512, float32),
runs 7 steps, then profiles one as [dygraph_bert] does and prints
`[probe] <tag>: wrapper=<launches the flash forward's wrapper counted>
profiled=<fwd_kernel_tf32wg records in the trace>`. Between the probes
the process runs, one after another, the ingredients of chip_smoke's
fleet phases: [kv_wire], a CUDA child process, the caching allocator
holding all but 0.2 GB of the card, a second paged GenerationEngine,
[router_serve] (on a BERT-base saved here, random weights) and the
replica processes of [router_hop] and [disagg_gen] (a random-weights
GPT-small). A probe whose two numbers differ lost a trace record.
"""
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
import paddle_tpu_torch as ptt  # noqa: E402
import paddle_tpu_torch.dygraph as dg  # noqa: E402
from paddle_tpu_torch.models import transformer  # noqa: E402
from paddle_tpu_torch.ops.cuda.flash_attention import \
    flash_attention  # noqa: E402
from paddle_tpu_torch.serving import GenerationEngine  # noqa: E402

ANSWERS = {"req_per_s": 1.0, "p50_ms": 0.0, "p99_ms": 0.0}


def probe(tag):
    cfg = transformer.bert_base(dropout=0.1, attn_dropout=0.0)
    toks = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (c.DYGRAPH_BATCH, c.T)).astype(np.int64)
    with dg.guard(), c.GlobalNormClip(ptt, 1.0):
        model = c.make_dygraph_bert(dg, ptt.layers, cfg)
        opt = c.dygraph_bert_opt(ptt, dg)
        inputs = (dg.to_variable(toks), dg.to_variable(toks.reshape(-1, 1)))

        def step():
            return c._dygraph_step(model, opt, inputs)

        c._dygraph_run(torch, step, 7)
        before = flash_attention.launches
        _, per = c._dygraph_profile(torch, step)
    print(f"[probe] {tag}: wrapper={flash_attention.launches - before} "
          f"profiled={c._symbol_launches(per, c.F32_FWD_SYMBOL)} "
          f"free_gb={torch.cuda.mem_get_info()[0] / 1e9:.2f}", flush=True)


def save_bert(model_dir):
    """A random-weights BERT-base saved as [serve] saves it, with
    [serve]'s requests and the engine's answers."""
    cfg = transformer.bert_base(use_flash=True, dropout=0.1,
                                attn_dropout=0.0)
    main, startup = ptt.Program(), ptt.Program()
    startup.random_seed = c.SEED
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        tokens = ptt.layers.data("tokens", shape=[c.T], dtype="int64")
        hidden = transformer.encoder(tokens, cfg)
    with ptt.scope_guard(ptt.Scope()):
        exe = ptt.Executor()
        exe.run(startup)
        ptt.io.save_inference_model(model_dir, ["tokens"], [hidden], exe,
                                    main_program=main)
    rng = np.random.RandomState(c.SEED)
    reqs = [rng.randint(0, cfg.vocab_size, (int(rng.randint(1, 4)), c.T))
            .astype("int64") for _ in range(c.N_REQUESTS)]
    engine = c._bert_engine(model_dir)
    engine.start()
    answers, _ = c._serve_pass(engine, reqs)
    engine.stop()
    return ({}, reqs, answers, ANSWERS)


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    c.check = lambda ok, msg: ok or print("CHECK FAILED:", msg, flush=True)
    c.build_phase()
    probe("baseline")
    c.kv_wire_phase(torch, "card")
    probe("after kv_wire")
    subprocess.run([sys.executable, "-c",
                    "import torch; torch.zeros(1, device='cuda')"],
                   check=True)
    probe("after a CUDA child process")
    torch.cuda.empty_cache()
    held = torch.empty(int(torch.cuda.mem_get_info()[0] - 0.2e9),
                       dtype=torch.uint8, device="cuda")
    del held
    probe("with the allocator's cache holding all but 0.2 GB")
    torch.cuda.empty_cache()
    gcfg = c._gpt_cfg(dropout=0.1)
    _, gstart, _ = c._build_gpt(ptt, gcfg, 1, True)
    gscope = ptt.Scope()
    ptt.Executor().run(gstart, scope=gscope)
    eng = GenerationEngine(gcfg, gscope, exe=ptt.Executor(),
                           max_slots=c.GEN_SLOTS, max_seq=c.GPT_SEQ,
                           paged=True, block_size=c.GEN_BLOCK,
                           state_prefix="gen2.")
    eng.start()
    eng.generate(list(range(40)), 4)
    eng.stop()
    probe("after a second paged GenerationEngine")
    tmp = tempfile.TemporaryDirectory()
    bert = os.path.join(tmp.name, "bert")
    served = save_bert(bert)
    c.router_serve_phase(torch, "card", bert, served, ANSWERS)
    probe("after router_serve")
    c.GEN_PROMPT_LENS = (1, 17, 64, 129)
    prompts, serial = c.gpt_generate_phase(torch, "card", gscope, gcfg)
    weights = c.write_gpt_weights(tmp.name, gscope, gcfg)
    fleet = c.start_fleet(tmp.name, bert, weights, gcfg)
    try:
        c.router_hop_phase(torch, "card", served, fleet)
        probe("after router_hop")
        c.disagg_gen_phase(torch, "card", prompts, serial, fleet,
                           {"ttft_p50_ms": 0.0, "ttft_p99_ms": 0.0})
    finally:
        for rep in fleet.values():
            rep.kill()
    probe("after disagg_gen")
    tmp.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
