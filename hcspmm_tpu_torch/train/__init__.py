from hcspmm_tpu_torch.train.loop import make_train_step, nll_loss, train  # noqa: F401
