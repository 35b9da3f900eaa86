"""Print PERF.md's parity table: run the CPU parity tests of the port
and report, per test and tolerance, the largest |port - JAX reference|
that its comparisons saw.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_parity_report.py [test files]

With file names (e.g. ``test_torch_train.py``) it runs only those.
"""
import re
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
FILES = ("test_torch_kernels.py", "test_torch_serve.py", "test_torch_moe.py",
         "test_torch_compile.py", "test_torch_passes.py", "test_torch_ssm.py",
         "test_torch_encdec.py", "test_torch_vlm.py", "test_torch_train.py",
         "test_torch_train_loop.py", "test_torch_train_moe.py", "test_torch_train_moe_steps.py",
         "test_torch_train_encdec.py")

#: test -> (port module, reference function it is held to)
TARGETS = {
    "test_matmul_matches_pallas": ("kernels/matmul.py", "programs.matmul, Pallas tile"),
    "test_matmul_ragged_matches_oracle": ("kernels/matmul.py", "ref.matmul_ref"),
    "test_rmsnorm_matches_pallas": ("kernels/rmsnorm.py", "programs.rmsnorm, Pallas rows"),
    "test_flash_attention_matches_pallas": ("kernels/flash_attention.py",
                                            "programs.flash_attention, Pallas attend"),
    "test_flash_attention_gqa_reads_kv_heads_by_index": ("kernels/flash_attention.py",
                                                         "Pallas attend, kv repeated"),
    "test_flash_attention_trainable_grads_match_jax": ("kernels/flash_attention.py",
                                                       "grad of flash_attention_trainable"),
    "test_flash_decode_matches_pallas": ("kernels/flash_attention.py",
                                         "flash_decode_pallas (interpret)"),
    "test_split_kv_decode_emulation_matches_pallas": (
        "tests/test_torch_kernels.py:_split_decode", "flash_decode_pallas (interpret)"),
    "test_prefill_logits_and_cache_match_jax": ("models/transformer.py", "transformer.prefill"),
    "test_decode_step_mid_sequence_matches_jax": ("models/transformer.py",
                                                  "transformer.decode_step"),
    "test_decode_step_per_slot_positions": ("models/transformer.py",
                                            "decode_step, batch-1 per slot"),
    "test_prefill_and_decode_bf16": ("models/transformer.py", "prefill + decode_step, bf16"),
    "test_moe_gemm_matches_pallas": ("kernels/moe_gemm.py",
                                     "programs.moe_gemm, Pallas expert_gemm; ref.moe_gemm_ref"),
    "test_split_expert_stream_emulation_matches_pallas": (
        "tests/test_torch_moe.py:_split_expert_gemm", "Pallas expert_gemm (interpret)"),
    "test_local_dispatch_matches_jax_with_dropped_tokens": ("models/moe.py",
                                                            "moe.local_combine (dropped tokens)"),
    "test_local_dispatch_matches_the_loop_oracle": ("models/moe.py",
                                                    "moe_routing_ref combine (JAX, port)"),
    "test_moe_apply_matches_jax": ("models/moe.py", "moe.moe_apply"),
    "test_moe_prefill_logits_and_cache_match_jax": ("models/transformer.py",
                                                    "transformer.prefill, MoE"),
    "test_moe_decode_step_mid_sequence_matches_jax": ("models/transformer.py",
                                                      "transformer.decode_step, MoE"),
    "test_moe_decode_step_per_slot_positions": ("models/transformer.py",
                                                "MoE decode_step, batch-1 per slot"),
    "test_moe_prefill_and_decode_bf16": ("models/transformer.py",
                                         "MoE prefill + decode_step, bf16"),
    "test_compiled_score_matches_jax_executable": (
        "axe/compile.py", "model_executable (mesh=None), ServeEngine.score"),
    "test_compiled_score_bf16_moe_matches_the_jax_model": (
        "axe/compile.py", "transformer.lm_forward, MoE bf16"),
    "test_compiled_decode_step_matches_jax_at_per_slot_positions": (
        "axe/compile.py", "decode_executable (mesh=None), ServeEngine.decode_step"),
    "test_matmul_epilogue_matches_pallas": (
        "kernels/matmul.py", "programs.matmul + Epilogue, Pallas tile (xla for gelu)"),
    "test_jax_kernel_drops_a_chain_without_extras": ("kernels/matmul.py", "jax.nn.gelu(a @ b)"),
    "test_fused_forward_matches_unfused_bitwise_and_jax": (
        "axe/passes.py + compile.py", "model_executable(fuse=True) (mesh=None)"),
    "test_fused_decode_matches_unfused_bitwise_and_jax": (
        "axe/passes.py + compile.py", "decode_executable(fuse=True) (mesh=None)"),
    "test_engine_fused_score_matches_unfused_and_jax": (
        "serve/engine.py", "ServeEngine(fuse=True).score"),
    "test_ssd_scan_matches_jax_and_the_recurrence": ("models/ssm.py", "ssm.ssd_scan, ssd_ref"),
    "test_causal_conv_matches_jax": ("models/ssm.py", "ssm._causal_conv"),
    "test_ssd_decode_matches_jax": ("models/ssm.py", "ssm.ssd_decode"),
    "test_prefill_and_per_slot_decode_match_jax": (
        "models/transformer.py", "SSM / hybrid prefill + decode_step per slot"),
    "test_compiled_score_and_decode_match_jax_executables": (
        "axe/compile.py", "ssm_mix / ssm_decode / side_output executables (mesh=None)"),
    "test_encdec_encode_matches_jax": ("models/encdec.py", "encdec.encode"),
    "test_attention_pieces_match_jax": ("models/attention.py",
                                        "attn_apply, cross_attn_apply"),
    "test_cross_decode_matches_jax": ("models/attention.py", "encdec._cross_decode"),
    "test_encdec_prefill_logits_and_cache_match_jax": ("models/encdec.py", "encdec.prefill"),
    "test_encdec_decode_steps_per_slot_match_jax": ("models/encdec.py",
                                                    "encdec.decode_step, per slot"),
    "test_vlm_embed_inputs_match_jax": ("models/transformer.py",
                                        "transformer._embed_inputs (patches)"),
    "test_vlm_prefill_and_decode_with_patches_match_jax": (
        "models/transformer.py", "VLM prefill + decode_step per slot"),
    "test_adamw_three_updates_match_jax": ("optim/adamw.py",
                                           "AdamW.update + apply_updates, 3 updates"),
    "test_adamw_step_in_place_clips_and_casts_as_the_reference": (
        "optim/adamw.py", "clip_by_global_norm + update + apply_updates, bf16"),
    "test_clip_by_global_norm_matches_jax": ("optim/adamw.py", "clip_by_global_norm"),
    "test_warmup_cosine_matches_jax": ("optim/schedule.py", "warmup_cosine"),
    "test_int8_helpers_match_jax": ("optim/grad_compress.py", "int8 helpers"),
    "test_error_feedback_matches_jax_and_reduces_bias": ("optim/grad_compress.py",
                                                         "error_feedback_update"),
    "test_lm_loss_and_grads_match_jax": ("models/transformer.py",
                                         "jax.value_and_grad(lm_loss), dense"),
    "test_ssm_and_vlm_loss_grads_match_jax": ("models/transformer.py",
                                              "jax.value_and_grad(lm_loss), SSM / VLM"),
    "test_lm_forward_logits_match_jax": ("models/transformer.py", "transformer.lm_forward"),
    "test_flash_attention_gqa_grads_match_jax": ("kernels/flash_attention.py",
                                                 "grad of flash_attention_trainable, GQA"),
    "test_train_steps_match_jax": ("train/train_loop.py", "make_train_step (jit), 1 / 3 steps"),
    "test_microbatch_grads_accumulate_in_f32_like_jax": ("train/train_loop.py",
                                                         "make_train_step, 2 microbatches"),
    "test_compiled_loss_grads_match_the_model_and_jax": (
        "axe/compile.py", "compiled_loss_fn grads (mesh=None)"),
    "test_moe_gemm_grad_route_matches_autograd_of_the_plain_formula": (
        "kernels/moe_gemm.py", "autograd of moe_gemm_plain (fwd, dX, dW)"),
    "test_dispatch_and_combine_grads_match_jax_with_drops_and_empty_experts": (
        "models/moe.py", "jax.grad of local_dispatch + einsum + local_combine"),
    "test_moe_and_hybrid_loss_and_grads_match_jax": (
        "models/transformer.py", "jax.value_and_grad(lm_loss), MoE / hybrid"),
    "test_moe_and_hybrid_bf16_loss_and_grads_routed_as_jax": (
        "models/transformer.py", "jitted value_and_grad(lm_loss), bf16, routed as JAX"),
    "test_moe_train_steps_match_jax": ("train/train_loop.py",
                                       "make_train_step (jit), MoE, 1 / 3 steps"),
    "test_moe_compiled_loss_grads_match_the_model_and_jax": (
        "axe/compile.py", "compiled_loss_fn grads, MoE (mesh=None)"),
    "test_hybrid_compiled_loss_grads_match_the_model": (
        "axe/compile.py", "the port's lm_loss grads, hybrid"),
    "test_encode_and_decode_train_match_jax": ("models/encdec.py",
                                               "encdec.encode, encdec.decode_train"),
    "test_encdec_loss_and_grads_match_jax": ("models/encdec.py",
                                             "jax.value_and_grad(encdec_loss)"),
    "test_whisper_train_steps_match_jax": ("train/train_loop.py",
                                           "make_train_step (jit), whisper, 1 / 3 steps"),
}


def main() -> int:
    sys.path.insert(0, str(HERE))
    import _torch_parity

    files = sys.argv[1:] or FILES
    rc = pytest.main(["-q", "-p", "no:cacheprovider", *(str(HERE / f) for f in files)])
    worst = {}
    for test, err, rtol, atol in _torch_parity.RECORDS:
        name = re.sub(r" \(call\)$", "", test.split("::")[-1])
        key = (name.split("[")[0], rtol, atol)
        if err > worst.get(key, ("", -1.0))[1]:
            worst[key] = (name, err)
    print("| port module | reference function | worst case | rtol / atol | max abs diff | device |")
    print("| --- | --- | --- | --- | --- | --- |")
    for (test, rtol, atol), (case, err) in sorted(worst.items()):
        module, reference = TARGETS.get(test, (test, "?"))
        case = case.partition("[")[2].rstrip("]") or "-"
        print(f"| `{module}` | `{reference}` | {case} | {rtol} / {atol} | {err:.3g} | cpu |")
    return int(rc)


if __name__ == "__main__":
    sys.exit(main())
