from koopman_realizations_torch.workflows.rand_models import evaluate_rand_models  # noqa: F401
