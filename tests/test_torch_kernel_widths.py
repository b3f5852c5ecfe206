"""The refusal of a head width that no kernel of a path takes
(``models.kernel_width_reason``), on the CPU: which layers reach which
kernel on a CUDA device (the paged path's three kernels on every layer,
flash on causal layers without a soft-cap, the dense decode on layers
with neither a window nor a soft-cap, each at head widths 64, 128, 256,
384, 512 and every multiple of 128 above 512; masked, windowed,
soft-capped, MLA, Mamba, Zamba and Whisper layers reach none), and that ``ServeEngine``, the dense and paged cache
constructors, the static forward and the serve CLI refuse such a config
on "cuda" before any weights are drawn, and never on "cpu"."""
import pytest
import torch

import repro_torch.kernels.decode_attention as tk
import repro_torch.launch.serve as tserve
import repro_torch.models as tm
import repro_torch.serving.engine as teng
from repro_torch.configs import all_configs, get_config
from repro_torch.configs.reduce import reduced
from repro_torch.models import lm as tlm
from repro_torch.serving import ServeEngine
from torch_kernel_inputs import PALI_TEXT, WIDE_TEXT, WIDER_TEXT

torch.set_num_threads(2)

ARCHS = sorted(c.name for c in (all_configs().values()
                                if isinstance(all_configs(), dict)
                                else all_configs()))
# the head widths with instances of their own (kernels._HEAD_DIMS); every
# multiple of 128 above 512 runs the width-generic instance
TAKEN = (64, 128, 256, 384, 512)
# what every kernel takes, as a refusal names it
TAKEN_TEXT = "[64, 128, 256, 384, 512] and every multiple of 128 above 512"
# reduced twins (head width 16) whose layers reach a kernel on each path
REFUSED_PAGED = {"arctic-480b", "command-r-plus-104b", "llama3.2-1b",
                 "qwen2.5-3b", "yi-6b"}
REFUSED_STATIC = REFUSED_PAGED | {"llava15-13b", "paligemma-3b"}


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_twins(arch):
    """Every dense, MoE and VLM twin is refused on the paths it runs;
    gemma3-1b's (every layer windowed or soft-capped) and the MLA, SSM,
    hybrid and encoder-decoder twins are not."""
    cfg = reduced(get_config(arch))
    assert cfg.head_dim in (0, 16) or cfg.family in ("ssm",)
    paged = tm.kernel_width_reason(cfg, "paged")
    static = tm.kernel_width_reason(cfg, "static")
    assert (paged is not None) == (arch in REFUSED_PAGED)
    assert (static is not None) == (arch in REFUSED_STATIC)
    for reason in (paged, static):
        if reason is not None:
            assert "head_dim 16" in reason and "--device cpu" in reason
            assert "[64, 128" in reason


def test_refusal_names_each_kernel_and_its_widths():
    cfg = reduced(get_config("llama3.2-1b"))
    taken = TAKEN_TEXT
    assert tk.TAKEN_WIDTHS == TAKEN_TEXT
    assert (f"paged decode / chunk prefill / spec verify takes {taken}"
            in tm.kernel_width_reason(cfg, "paged"))
    static = tm.kernel_width_reason(cfg, "static")
    assert f"flash attention takes {taken}" in static
    assert f"dense decode takes {taken}" in static
    # paligemma's prompt is prefix-LM (no flash): only its dense decode
    pali = reduced(get_config("paligemma-3b"))
    assert tm.kernel_width_reason(pali, "prefill") is None
    assert "dense decode" in tm.kernel_width_reason(pali, "decode")
    with pytest.raises(ValueError, match="unknown path"):
        tm.kernel_width_reason(cfg, "train")


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2.5-3b", "arctic-480b",
                                  "llava15-13b", "paligemma-3b", "gemma3-1b",
                                  "deepseek-v2-236b", "yi-6b"])
def test_full_width_not_refused(arch):
    """Full width takes every kernel it reaches: head width 64, 128 or
    256 (paligemma-3b's prompt is prefix-LM, so its static path reaches
    the dense decode alone)."""
    cfg = get_config(arch)
    for path in ("paged", "prefill", "decode", "static"):
        assert tm.kernel_width_reason(cfg, path) is None, path
    if arch == "paligemma-3b":
        assert cfg.head_dim == 256
        assert tlm._kernel_layers(cfg, "static") == ["dense decode"]


def test_a_width_no_kernel_takes_is_refused_at_full_width():
    """A full-width config at head width 96 reaches flash, the dense decode
    and the paged kernels, and each refuses it; at 256 (no window, no
    soft-cap) every kernel takes it, on both engines."""
    cfg = get_config("qwen2.5-3b").replace(head_dim=96)
    reason = tm.kernel_width_reason(cfg, "static")
    assert "head_dim 96" in reason
    assert "flash attention" in reason and "dense decode" in reason
    assert "head_dim 96" in tm.kernel_width_reason(cfg, "paged")
    wide = get_config("qwen2.5-3b").replace(head_dim=256)
    for path in ("paged", "prefill", "decode", "static"):
        assert tm.kernel_width_reason(wide, path) is None, path
    assert tlm._kernel_layers(wide, "static") == ["flash attention",
                                                  "dense decode"]



# the kernels each path reaches on the derived text decoder
TEXT_KERNELS = {"paged": ["paged decode / chunk prefill / spec verify"],
                "prefill": ["flash attention"], "decode": ["dense decode"],
                "static": ["flash attention", "dense decode"]}


@pytest.mark.parametrize("path", sorted(TEXT_KERNELS))
def test_paligemma_text_decoder_reaches_every_kernel_at_256(path):
    """paligemma-3b's Gemma-2B decoder as a text-only causal LM (18 layers,
    8 query heads over 1 KV head, dh 256) runs on the paged path and takes
    flash on the static one; no path refuses it on the card."""
    cfg = get_config("paligemma-3b").replace(**PALI_TEXT)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim) == (18, 2048, 8, 1, 256)
    assert tm.paged_supported(cfg) is None
    # the image-prefixed model itself stays off the paged path
    assert tm.paged_supported(get_config("paligemma-3b")) is not None
    assert tm.kernel_width_reason(cfg, path) is None
    assert tlm._kernel_layers(cfg, path) == TEXT_KERNELS[path]


# every multiple of 128 above 512 is taken (the width-generic instance)
WIDER = (640, 768, 896, 1024, 1152, 1536, 2048)


@pytest.mark.parametrize("path", ["paged", "prefill", "decode", "static"])
@pytest.mark.parametrize("dh", [16, 64, 80, 96, 128, 192, 256, 384, 512,
                                576, 640, 768, 1000, 1024, 2048])
def test_only_the_built_widths_are_taken(dh, path):
    """On each path a full-width dense config is taken at 64, 128, 256,
    384, 512 and every multiple of 128 above 512 (640, 768, 1024, 2048)
    and refused at any other width (16, 80, 96, 192, MLA's absorbed 512 +
    64 = 576, 1000), with a reason that names the widths taken."""
    cfg = get_config("qwen2.5-3b").replace(head_dim=dh)
    reason = tm.kernel_width_reason(cfg, path)
    assert tk._HEAD_DIMS == TAKEN
    assert tk.head_dim_taken(dh) == (dh in TAKEN or dh in WIDER)
    if dh in TAKEN or dh in WIDER:
        assert reason is None
    else:
        assert f"head_dim {dh}" in reason and TAKEN_TEXT in reason


@pytest.mark.parametrize("dh", WIDER)
def test_every_multiple_of_128_above_512_is_taken(dh):
    """At every multiple of 128 from 640 to 2048 a full-width dense config
    is taken on every path, and the wrappers' check admits the width."""
    cfg = get_config("qwen2.5-3b").replace(head_dim=dh)
    for path in ("paged", "prefill", "decode", "static"):
        assert tm.kernel_width_reason(cfg, path) is None, path
    assert tk.head_dim_taken(dh) and not tk.head_dim_taken(dh + 64)


@pytest.mark.parametrize("path", sorted(TEXT_KERNELS))
def test_wide_text_decoder_reaches_every_kernel_at_512(path):
    """The dh-512 text decoder (paligemma-3b's Gemma-2B decoder with its 8
    heads of 256 regrouped as 4 of 512 over its 1 KV head) keeps the
    model's widths, reaches every kernel at 512 and is refused by none;
    at 576 every kernel it reaches refuses it, naming the widths taken."""
    cfg = get_config("paligemma-3b").replace(**WIDE_TEXT)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab) == (18, 2048, 4, 1, 512,
                                                   16384, 257216)
    assert tm.paged_supported(cfg) is None
    assert tm.kernel_width_reason(cfg, path) is None
    assert tlm._kernel_layers(cfg, path) == TEXT_KERNELS[path]
    wider = tm.kernel_width_reason(cfg.replace(head_dim=576), path)
    assert "head_dim 576" in wider and "--device cpu" in wider
    for name in TEXT_KERNELS[path]:
        assert f"the {name} takes {TAKEN_TEXT}" in wider


@pytest.mark.parametrize("path", sorted(TEXT_KERNELS))
def test_wider_text_decoder_reaches_every_kernel_at_1024(path):
    """The dh-1024 text decoder (the same decoder's 8 heads of 256
    regrouped as 2 of 1024 over its 1 KV head) keeps the model's widths
    and reaches every kernel at 1024, the width-generic instances, and is
    refused by none; at 1000 every kernel it reaches refuses it."""
    cfg = get_config("paligemma-3b").replace(**WIDER_TEXT)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab) == (18, 2048, 2, 1, 1024,
                                                   16384, 257216)
    assert tm.paged_supported(cfg) is None
    assert tm.kernel_width_reason(cfg, path) is None
    assert tlm._kernel_layers(cfg, path) == TEXT_KERNELS[path]
    odd = tm.kernel_width_reason(cfg.replace(head_dim=1000), path)
    assert "head_dim 1000" in odd and TAKEN_TEXT in odd


def test_a_wider_width_is_refused_before_weights(no_init):
    """576 and 1000 are refused on the card before any weights are drawn,
    on both engines; 1024 passes the width check and goes on to the
    device."""
    cfg = reduced(get_config("paligemma-3b")).replace(**WIDER_TEXT)
    for dh in (576, 1000):
        for scheduler in ("continuous", "static"):
            with pytest.raises(NotImplementedError,
                               match=f"head_dim {dh}.*every multiple of 128"):
                ServeEngine(cfg.replace(head_dim=dh), device="cuda",
                            scheduler=scheduler)
    want = ("init_params was called" if torch.cuda.is_available()
            else "CUDA is not available")
    with pytest.raises((AssertionError, RuntimeError), match=want):
        ServeEngine(cfg, device="cuda", scheduler="continuous")


def test_the_refusal_comes_before_weights_for_the_text_decoder_twin(no_init):
    """The derived decoder's reduced twin (head width 16) is refused on the
    card before any weights are drawn; with head_dim set back to 256 it
    passes the width check and goes on to the device."""
    twin = reduced(get_config("paligemma-3b")).replace(**PALI_TEXT)
    with pytest.raises(NotImplementedError, match="head_dim 16"):
        ServeEngine(twin, device="cuda", scheduler="continuous")
    wide = twin.replace(head_dim=256)
    want = ("init_params was called" if torch.cuda.is_available()
            else "CUDA is not available")
    for scheduler in ("continuous", "static"):
        with pytest.raises((AssertionError, RuntimeError), match=want):
            ServeEngine(wide, device="cuda", scheduler=scheduler)


@pytest.fixture
def no_init(monkeypatch):
    """Weights drawn by the engine fail the test."""
    def boom(*a, **k):
        raise AssertionError("init_params was called")
    monkeypatch.setattr(teng, "init_params", boom)


@pytest.mark.parametrize("scheduler", ["continuous", "static"])
def test_engine_refuses_before_drawing_weights(no_init, scheduler):
    cfg = reduced(get_config("llama3.2-1b"))
    with pytest.raises(NotImplementedError, match="head_dim 16"):
        ServeEngine(cfg, device="cuda", scheduler=scheduler)


def test_engine_refuses_a_model_draft(no_init):
    cfg = get_config("llama3.2-1b")
    with pytest.raises(NotImplementedError, match="head_dim 16"):
        ServeEngine(cfg, device="cuda", spec_mode="model",
                    draft_cfg=reduced(cfg))


def test_gemma3_twin_is_not_refused(no_init):
    """gemma3-1b's twin reaches no kernel: the engine passes the width
    check and goes on to the device (without a card: "CUDA is not
    available") and to drawing its weights (where this test stops it)."""
    cfg = reduced(get_config("gemma3-1b"))
    want = ("init_params was called" if torch.cuda.is_available()
            else "CUDA is not available")
    with pytest.raises((AssertionError, RuntimeError), match=want):
        ServeEngine(cfg, device="cuda", scheduler="static")


def test_nothing_is_refused_on_the_cpu():
    cfg = reduced(get_config("llama3.2-1b"))
    for scheduler in ("continuous", "static"):
        eng = ServeEngine(cfg, device="cpu", scheduler=scheduler, max_len=32)
        assert eng.device.type == "cpu"
    tm.init_cache(cfg, 1, 8, device="cpu")
    tm.init_paged_cache(cfg, 4, 16, device="cpu")
    for path in ("paged", "static", "prefill"):
        tlm._refuse_width(cfg, path, "cpu")
        with pytest.raises(NotImplementedError, match="head_dim 16"):
            tlm._refuse_width(cfg, path, "cuda")


def test_serve_cli_reduced_on_cuda_refuses(no_init):
    with pytest.raises(NotImplementedError, match="--device cpu"):
        tserve.main(["--arch", "llama3.2-1b", "--reduced"])
