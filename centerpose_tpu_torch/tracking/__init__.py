"""CenterPoseTrack: previous-frame rendering, Kalman filtering and the tracker."""
