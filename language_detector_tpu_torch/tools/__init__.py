"""The offline entry points over the port's engine, each run as
`python -m language_detector_tpu_torch.tools.<name>`:

    eval_corpus         per-language precision / recall / F over a TSV
    gen_expected_score  the expected-score-per-KB table from a TSV
    soak                every engine path against the scalar engine
    profile_score       host-clock timings of the device step
    profile_pack        per-stage cycles of the native packer

Each keeps the reference package's CLI, output and exit codes. The
ones that run the engine take --device (default cuda, which raises
without CUDA; cpu scores with the plain PyTorch version) and never fall
back to the scalar engine.
"""
