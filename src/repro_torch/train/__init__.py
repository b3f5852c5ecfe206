from repro_torch.train.loop import TrainConfig, build_train_step, train

__all__ = ["TrainConfig", "build_train_step", "train"]
