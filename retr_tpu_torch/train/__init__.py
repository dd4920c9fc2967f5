from retr_tpu_torch.train.state import TrainState, create_train_state, make_train_step  # noqa: F401
