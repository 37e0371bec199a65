"""The port's command line: ``python -m indic_cl_asr_torch.scripts.<name>``
for the CL drivers (cl_baseline, cl_ewc, cl_mas, cl_lwf), finetune,
transcribe, results and the data-prep scripts (dataset_gen,
train_tokenizer). Each ``main(argv=None)`` parses its arguments as its
counterpart in the JAX package's scripts/ does; the drivers and
transcribe also take ``--device`` (default ``cuda``)."""
