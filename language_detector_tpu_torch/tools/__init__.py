"""The offline entry points over the port's engine, each run as
`python -m language_detector_tpu_torch.tools.<name>`:

    eval_corpus         per-language precision / recall / F over a TSV
    gen_expected_score  the expected-score-per-KB table from a TSV
    soak                every engine path against the scalar engine
    profile_score       host-clock timings of the device step
    profile_pack        per-stage cycles of the native packer
    bench_service       docs/sec through the service fronts over HTTP
                        (and the unix-socket lane)
    cldr_vocab          labeled vocabulary from babel's CLDR data
    train_quad_tables   the quadgram tables from the snapshot's octagram
                        words and CLDR phrases (npz under build/)
    calibrate_quad_tables
                        win-rate bias calibration and expected scores
                        for the trained tables over dev documents
    sweep_quad_tables   the trainer's hyperparameters on the golden
                        suite
    artifact_tool       dump, verify, and pack the npz pair into the
                        served model.ldta with its golden canaries
    gen_service_codes   the service's code -> language-name map
    make_eval_corpus    a labeled TSV of golden-suite windows

Each keeps the reference package's CLI, output and exit codes. The
ones that run the engine take --device (default cuda, which raises
without CUDA; cpu scores with the plain PyTorch version) and never fall
back to the scalar engine. The quad trainers and the table tools
write under build/, never into the shipped language_detector_tpu/data/
or service/cld_codes.json.
"""
