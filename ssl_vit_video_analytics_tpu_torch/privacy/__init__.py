from .feature import add_gaussian_noise, apply_feature_mask, perturb_features
from .attacker import FeatureAttacker, train_attacker
from .visual import (
    YuNetFaceDetector, StubFaceDetector, VisualAnonymizer, make_detector, boxes_to_mask,
)
from .metrics import prediction_entropy, privacy_exposure_rate, top1_accuracy
